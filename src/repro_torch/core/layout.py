"""Stage layout shared by the pipelined serving engine and the pipeline
training executor (own copy of ``repro.core.pipeline_runtime``'s
``pipeline_period`` and ``StageLayout``).

The decoder's ``L`` layers are padded to a multiple of ``P * v *
period`` and cut into ``P * v`` contiguous blocks of ``K`` layers; the
block at (device ``d``, chunk ``c``) is the placement's
``block(d, c)`` — ``c * P + d`` under the interleaved striping.  Padding
layers (global index ``>= L``) carry gate 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.placement import Placement


def pipeline_period(cfg: ModelConfig) -> int:
    """Structural period (param-tree shape changes); attention
    local/global patterns are data flags, not structure."""
    p = 1
    if cfg.ssm is not None and cfg.ssm.attn_period:
        p = math.lcm(p, cfg.ssm.attn_period)
    if cfg.moe is not None and cfg.moe.layer_period > 1:
        p = math.lcm(p, cfg.moe.layer_period)
    return p


@dataclass(frozen=True)
class StageLayout:
    P: int
    v: int
    L: int              # real layers
    L_pad: int
    K: int              # layers per (device, chunk) block
    period: int         # structural period
    M: int              # periods per block = K // period
    pl: Placement       # layer-block <-> device assignment
    lm_period: int = 1  # the LM's stacking period (cfg.period)

    @staticmethod
    def build(cfg: ModelConfig, P: int, v: int,
              placement: Placement) -> "StageLayout":
        per = pipeline_period(cfg)
        quantum = P * v * per
        L_pad = -(-cfg.num_layers // quantum) * quantum
        K = L_pad // (P * v)
        return StageLayout(P=P, v=v, L=cfg.num_layers, L_pad=L_pad, K=K,
                           period=per, M=K // per, pl=placement,
                           lm_period=cfg.period)

    def global_idx(self, d: int, c: int, j: int) -> int:
        """Global layer index of local layer ``j`` of the block at
        (device ``d``, chunk ``c``)."""
        return self.pl.block(d, c) * self.K + j

    def flags(self, cfg: ModelConfig) -> Dict[str, np.ndarray]:
        """window [P,v,M,period] int32; gate [P,v,M,period] f32 —
        indexed by (device, chunk), following the placement."""
        win = np.zeros((self.P, self.v, self.M, self.period), np.int32)
        gate = np.zeros((self.P, self.v, self.M, self.period), np.float32)
        for d in range(self.P):
            for c in range(self.v):
                for mi in range(self.M):
                    for j in range(self.period):
                        g = self.global_idx(d, c, mi * self.period + j)
                        if g < self.L:
                            gate[d, c, mi, j] = 1.0
                            win[d, c, mi, j] = (
                                0 if cfg.layer_is_global(g)
                                else cfg.sliding_window)
        return {"window": win, "gate": gate}
