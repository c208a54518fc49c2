"""Chronos-Offload timing model, §5.1 Eq. (4)-(7) of the paper (own copy
of ``OffloadTiming``, ``offload_timing`` and ``_embed_params`` from
``repro/core/analysis.py``; the rest of that module, the memory model
and the closed forms, is ROADMAP A.8).

The model's inputs (``gpu_flops``, ``pcie_gbps``, ``cpu_flops``) are
the paper testbed's figures, not measurements of this machine.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig

BF16 = 2


def _embed_params(cfg: ModelConfig) -> float:
    n = cfg.vocab_size * cfg.d_model
    return n if cfg.tie_embeddings else 2 * n


@dataclass(frozen=True)
class OffloadTiming:
    t_bwd: float            # backward time of one microbatch, seconds
    t_fwd: float
    t_step: float           # offload grads + CPU optimizer, all layers
    t_upload: float         # upload quantized weights, all layers
    p: int

    @property
    def available_offload(self) -> float:
        p = self.p
        return (p - math.ceil((2 * p - 3) / 6) - 1) * self.t_bwd / (2 * p)

    @property
    def available_upload(self) -> float:
        p = self.p
        return (p - math.ceil((p - 3) / 6) - 1) * self.t_fwd / (2 * p)

    @property
    def offload_ok(self) -> bool:                      # Eq. (5)
        return self.t_step / (2 * self.p) <= self.available_offload + 1e-12

    @property
    def upload_ok(self) -> bool:                       # Eq. (7)
        return self.t_upload / (2 * self.p) <= self.available_upload + 1e-12

    @property
    def overlap_ratio(self) -> float:
        """Fraction of the offload work hidden in the cooldown bubbles
        (Fig. 14's 45.45% / 94.55% / 100%)."""
        need = self.t_step / (2 * self.p)
        if need <= 0:
            return 1.0
        return min(1.0, self.available_offload / need)

    @property
    def exposed_time(self) -> float:
        """Extra iteration time not hidden by bubbles."""
        need = self.t_step / (2 * self.p)
        return max(0.0, need - self.available_offload) * 2 * self.p


def offload_timing(cfg: ModelConfig, *, seq_len: int, microbatch: int,
                   pp: int, tp: int, dp: int = 1,
                   gpu_flops: float = 100e12, pcie_gbps: float = 32.0,
                   cpu_flops: float = 2.0e12,
                   offload_frac: float = 0.5) -> OffloadTiming:
    """Estimate Eq.(4)-(7) terms for a model/parallelism point."""
    tokens = seq_len * microbatch
    n_body = cfg.param_count() - _embed_params(cfg)
    flops_fwd = 2 * n_body * tokens          # dense matmul fwd
    # attention extra: 2 * 2 * s^2 * h per layer-ish — include quadratic term
    attn_layers = sum(1 for i in range(cfg.num_layers)
                      if cfg.layer_kind(i) == "attn")
    flops_fwd += 4 * attn_layers * seq_len * tokens * cfg.resolved_head_dim \
        * cfg.num_heads
    # T_fwd in the paper is the full-net time of one microbatch: tp only
    t_fwd = flops_fwd / (gpu_flops * tp)
    t_bwd = 2 * t_fwd
    # offloaded model state for the deep chunks, per DP rank
    n_off = n_body * offload_frac / (pp * tp * dp)
    grad_bytes = 4 * n_off                              # fp32 grads down
    up_bytes = BF16 * n_off                             # bf16 weights up
    cpu_time = 10 * n_off / cpu_flops                   # ~10 elementwise ops
    t_step = grad_bytes / (pcie_gbps * 1e9) + cpu_time
    t_upload = up_bytes / (pcie_gbps * 1e9)
    # Eq. (4)-(7) are written for the whole-net totals (T_step covers all
    # offloaded layers across the 2p cooldown slots)
    return OffloadTiming(t_bwd=t_bwd, t_fwd=t_fwd,
                         t_step=t_step * 2 * pp, t_upload=t_upload * 2 * pp,
                         p=pp)
