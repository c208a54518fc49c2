"""Pluggable (stage, chunk) -> device / layer-block placement (own copy
of ``repro/core/placement.py``, pure Python).

The schedule IR keeps *stage* as the pipeline-position coordinate: chunk
``c``'s forward traverses stages ``0..P-1`` in order, and every
dependency rule in :mod:`repro_torch.core.schedule` is written in stage
space.  Which *device* executes a (stage, chunk) pair — and therefore
which layer-block's parameters live on that device — is a separate,
pluggable concern: a :class:`Placement`.

Two placements are registered:

- ``interleaved`` (the base class): chunk ``c`` stage ``s`` runs on
  device ``s`` and holds layer-block ``c*P + s``, the placement of every
  chronos / interleaved / ZB / seq generator;
- ``vshape`` (:class:`VShapePlacement`, the V-shape family of *Pipeline
  Parallelism with Controllable Memory*): odd chunks descend the devices
  (device = ``P-1-s``), so at v=2 device ``d`` holds blocks ``d`` and
  ``2P-1-d`` and both chunk hops (the forward's mid-network hop and the
  backward's) stay on one device.

Invariant the task-table compiler relies on: for every chunk ``c``,
``device(., c)`` is a bijection on ``0..P-1`` — each device hosts exactly
one stage of each chunk, so per-chunk ring buffers stay one-per-device.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Placement:
    """Base class *and* the identity (interleaved striping) placement."""
    P: int
    v: int

    name = "interleaved"

    # -- the two mappings every layer consumes ----------------------------
    def device(self, stage: int, chunk: int) -> int:
        """Device executing (stage, chunk)."""
        return stage

    def stage(self, device: int, chunk: int) -> int:
        """Inverse of :meth:`device` for a fixed chunk."""
        return device

    def block(self, device: int, chunk: int) -> int:
        """Global layer-block index (0..v*P-1, shallow to deep) whose
        parameters live at (device, chunk)."""
        return chunk * self.P + self.stage(device, chunk)

    # -- derived helpers ---------------------------------------------------
    def describe(self) -> str:
        return "interleaved striping: device == stage, block c*P + s"

    def block_of_stage(self, stage: int, chunk: int) -> int:
        return self.block(self.device(stage, chunk), chunk)

    def is_local(self, stage_a: int, chunk_a: int,
                 stage_b: int, chunk_b: int) -> bool:
        return self.device(stage_a, chunk_a) == self.device(stage_b,
                                                            chunk_b)

    def check(self) -> None:
        """Re-derive the bijection + block-partition invariants."""
        blocks = set()
        for c in range(self.v):
            devs = [self.device(s, c) for s in range(self.P)]
            assert sorted(devs) == list(range(self.P)), \
                f"{self.name}: device(., chunk={c}) is not a bijection"
            for s in range(self.P):
                d = self.device(s, c)
                assert self.stage(d, c) == s, \
                    f"{self.name}: stage/device not inverse at ({s}, {c})"
                blocks.add(self.block(d, c))
        assert blocks == set(range(self.v * self.P)), \
            f"{self.name}: blocks are not a partition of the layer stack"


class InterleavedPlacement(Placement):
    """Alias of the base identity placement, for explicitness."""


@dataclass(frozen=True)
class VShapePlacement(Placement):
    """Fold-back zigzag: odd chunks descend the devices, making the
    chunk hops device-local (see module docstring)."""

    name = "vshape"

    def describe(self) -> str:
        if self.v == 2:
            return (f"fold-back: device d holds blocks d and "
                    f"{2 * self.P - 1}-d; chunk hops are device-local")
        return ("zigzag fold-back: odd chunks descend the devices; "
                "chunk hops are device-local")

    def device(self, stage: int, chunk: int) -> int:
        return stage if chunk % 2 == 0 else self.P - 1 - stage

    def stage(self, device: int, chunk: int) -> int:
        return device if chunk % 2 == 0 else self.P - 1 - device


PLACEMENTS = {
    "interleaved": InterleavedPlacement,
    "vshape": VShapePlacement,
}


def get_placement(name: str, P: int, v: int) -> Placement:
    if name not in PLACEMENTS:
        raise ValueError(f"unknown placement {name!r}; registered: "
                         f"{', '.join(sorted(PLACEMENTS))}")
    pl = PLACEMENTS[name](P, v)
    pl.check()
    return pl
