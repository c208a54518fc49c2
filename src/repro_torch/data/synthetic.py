"""Deterministic synthetic LM token stream (checkpointable; own copy of
``repro/data/synthetic.py``).

Generates Zipf-distributed tokens with short-range structure (enough for
a 100M model to show a decreasing loss in the examples) from a counter-
based RNG: state is just (seed, position), so resuming from a checkpoint
reproduces the exact stream.

:class:`SyntheticEmbeds` adds the stub frontends' inputs a VLM or an
encoder-decoder config trains on (the reference's pipeline emits tokens
only): fp32 patch or frame embeddings drawn from ``torch.Generator`` s
seeded by (seed, position), beside the same token stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    seed: int = 0
    position: int = 0

    def next_batch(self, batch: int) -> np.ndarray:
        out = np.empty((batch, self.seq_len), np.int32)
        for b in range(batch):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.position + b]))
            # Zipf-ish marginal
            z = rng.zipf(1.3, size=self.seq_len).astype(np.int64)
            toks = (z - 1) % self.vocab_size
            # short-range structure: every even position repeats a
            # function of its predecessor (learnable bigram signal)
            # (the reference's ``toks[0::2]`` has one value too many for
            # an odd seq_len and raises there; the predecessors of the
            # odd positions are the same values for any length)
            toks[1::2] = (toks[0:-1:2] * 31 + 7) % self.vocab_size
            out[b] = toks.astype(np.int32)
        self.position += batch
        return out

    # -- checkpointable state ------------------------------------------
    def state(self) -> Dict:
        return {"seed": self.seed, "position": self.position}

    def load_state(self, st: Dict) -> None:
        self.seed = int(st["seed"])
        self.position = int(st["position"])


@dataclass
class SyntheticEmbeds:
    """:class:`SyntheticLM`'s tokens plus N(0, 1) fp32 embeddings
    ``[batch, length, d_model]`` under ``key`` (``"patch_embeds"`` or
    ``"frame_embeds"``); each sequence's embeddings come from a
    ``torch.Generator`` seeded by its (seed, position), so the stream
    resumes exactly from ``state()``."""
    tokens: SyntheticLM
    key: str
    length: int
    d_model: int

    def next_batch(self, batch: int) -> Dict[str, np.ndarray]:
        tok = self.tokens
        emb = np.empty((batch, self.length, self.d_model), np.float32)
        for b in range(batch):
            gen = torch.Generator().manual_seed(
                tok.seed * 1_000_003 + tok.position + b)
            emb[b] = torch.randn((self.length, self.d_model),
                                 generator=gen).numpy()
        return {"tokens": tok.next_batch(batch), self.key: emb}

    def state(self) -> Dict:
        return self.tokens.state()

    def load_state(self, st: Dict) -> None:
        self.tokens.load_state(st)


def synthetic_source(cfg, seq_len: int, seed: int = 0):
    """The default training stream of ``cfg``: tokens, plus the patch
    embeddings of a VLM or the frame embeddings of an encoder-decoder."""
    tokens = SyntheticLM(cfg.vocab_size, seq_len, seed=seed)
    if cfg.vision is not None:
        return SyntheticEmbeds(tokens, "patch_embeds",
                               cfg.vision.num_patches, cfg.d_model)
    if cfg.encdec is not None:
        return SyntheticEmbeds(tokens, "frame_embeds", cfg.encdec.num_frames,
                               cfg.d_model)
    return tokens
