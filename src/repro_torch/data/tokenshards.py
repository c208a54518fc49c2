"""Memory-mapped pre-tokenized shard format + resumable reader (own copy
of ``repro/data/tokenshards.py``: the same file format and state).

Format (little-endian):
    magic  u32 = 0x544F4B53 ("TOKS")
    dtype  u32 (2 = uint16, 4 = uint32)
    seqlen u32
    count  u32
    data   count * seqlen tokens

Reader semantics: shards are striped across DP ranks (rank r reads
sequences r, r+R, r+2R, ... of the concatenated shard list), shuffled
per epoch with a seeded permutation; state = (epoch, cursor) so a
restart resumes mid-epoch exactly.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Sequence

import numpy as np

MAGIC = 0x544F4B53


class ShardWriter:
    def __init__(self, path: str, seq_len: int, dtype=np.uint16):
        self.path = path
        self.seq_len = seq_len
        self.dtype = np.dtype(dtype)
        self._rows: List[np.ndarray] = []

    def add(self, tokens: np.ndarray) -> None:
        assert tokens.shape == (self.seq_len,)
        self._rows.append(tokens.astype(self.dtype))

    def close(self) -> None:
        with open(self.path, "wb") as f:
            f.write(struct.pack("<IIII", MAGIC, self.dtype.itemsize,
                                self.seq_len, len(self._rows)))
            for r in self._rows:
                f.write(r.tobytes())


class TokenShardDataset:
    """mmap reader over a list of shard files, DP-rank-striped,
    per-epoch shuffled, checkpointable."""

    def __init__(self, paths: Sequence[str], dp_rank: int = 0,
                 dp_size: int = 1, seed: int = 0):
        self.paths = list(paths)
        self.dp_rank, self.dp_size, self.seed = dp_rank, dp_size, seed
        self.maps, self.counts, self.seq_len = [], [], None
        for p in self.paths:
            with open(p, "rb") as f:
                magic, isz, seqlen, count = struct.unpack(
                    "<IIII", f.read(16))
            assert magic == MAGIC, f"bad shard {p}"
            dtype = {2: np.uint16, 4: np.uint32}[isz]
            mm = np.memmap(p, dtype=dtype, mode="r", offset=16,
                           shape=(count, seqlen))
            if self.seq_len is None:
                self.seq_len = seqlen
            assert seqlen == self.seq_len
            self.maps.append(mm)
            self.counts.append(count)
        self.total = sum(self.counts)
        self.offsets = np.cumsum([0] + self.counts)
        self.epoch = 0
        self.cursor = 0           # index into this rank's stripe
        self._perm = None

    def _stripe(self) -> np.ndarray:
        if self._perm is None:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch]))
            self._perm = rng.permutation(self.total)
        return self._perm[self.dp_rank::self.dp_size]

    def __len__(self) -> int:
        return len(self._stripe())

    def _fetch(self, global_idx: int) -> np.ndarray:
        shard = int(np.searchsorted(self.offsets, global_idx,
                                    side="right")) - 1
        row = global_idx - self.offsets[shard]
        return np.asarray(self.maps[shard][row], np.int32)

    def next_batch(self, batch: int) -> np.ndarray:
        stripe = self._stripe()
        out = np.empty((batch, self.seq_len), np.int32)
        for i in range(batch):
            if self.cursor >= len(stripe):
                self.epoch += 1
                self.cursor = 0
                self._perm = None
                stripe = self._stripe()
            out[i] = self._fetch(int(stripe[self.cursor]))
            self.cursor += 1
        return out

    # -- checkpointable state ------------------------------------------
    def state(self) -> Dict:
        return {"epoch": self.epoch, "cursor": self.cursor,
                "seed": self.seed, "dp_rank": self.dp_rank,
                "dp_size": self.dp_size}

    def load_state(self, st: Dict) -> None:
        self.epoch, self.cursor = int(st["epoch"]), int(st["cursor"])
        self.seed = int(st["seed"])
        self._perm = None


def write_synthetic_shards(directory: str, *, vocab: int, seq_len: int,
                           num_shards: int = 2, per_shard: int = 64,
                           seed: int = 0) -> List[str]:
    """Utility for examples/tests: materialize synthetic data as shards."""
    from repro_torch.data.synthetic import SyntheticLM
    os.makedirs(directory, exist_ok=True)
    gen = SyntheticLM(min(vocab, 65535), seq_len, seed=seed)
    paths = []
    for i in range(num_shards):
        p = os.path.join(directory, f"shard_{i:04d}.toks")
        w = ShardWriter(p, seq_len)
        for row in gen.next_batch(per_shard):
            w.add(row.astype(np.uint16))
        w.close()
        paths.append(p)
    return paths
