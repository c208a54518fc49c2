"""Deterministic synthetic LM token stream (checkpointable; own copy of
``repro/data/synthetic.py``).

Generates Zipf-distributed tokens with short-range structure (enough for
a 100M model to show a decreasing loss in the examples) from a counter-
based RNG: state is just (seed, position), so resuming from a checkpoint
reproduces the exact stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


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
