"""Closed-form models from the paper + byte-level memory estimator (own
copy of ``repro/core/analysis.py``).

Three layers of modelling:

1. *Schedule-level* (units of m_a, grains): exact peak/bubble numbers come
   from the constructed schedules in :mod:`repro_torch.core.schedules`;
   this module adds the paper's closed forms for cross-checking (§4.1,
   §4.2).
2. *Byte-level*: per-token/per-layer activation bytes and per-parameter
   model-state bytes for any :class:`ModelConfig`, with TP/SP division —
   what the memory-budget planner (:mod:`repro_torch.plan`) scores.
3. *Chronos-Offload* (§5.1): Eq. (4)-(7) bubble-budget conditions and the
   overlap ratio reported in Fig. 14.

Everything here is host arithmetic on numbers and schedules; nothing
reads a device.  The offload model's inputs (``gpu_flops``,
``pcie_gbps``, ``cpu_flops``) are the paper testbed's figures, not
measurements of this machine.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig

BF16 = 2


# ---------------------------------------------------------------------------
# §4.1 / §4.2 closed forms (cross-checks for the constructed schedules)
# ---------------------------------------------------------------------------

def chronos_peak_frac(P: int) -> float:
    """Paper §4.1: peak activation fraction of m_a for chronos v=2."""
    c1 = math.ceil(2 / 3 + math.ceil((P - 3) / 6)
                   + math.ceil((2 * P - 3) / 6) + P / 2)
    c2 = math.ceil((3 * P - 2) / 6)
    return (c1 + c2) / (2 * P)


def chronos_recomp_peak_frac(P: int) -> float:
    """Paper §4.2: remaining activation with full recompute of chunk 1."""
    return (P // 2) / (2 * P)


def chronos_bubble(P: int, m: int, tc: float) -> float:
    """Paper §4.1 closed form, tc in units of T_unit."""
    num = 6 * (P - 1) + (4 * P + 8 * (m - 2) + 2) * tc
    den = 6 * (P - 1 + m) + (4 * P + 8 * (m - 2) + 2) * tc
    return num / den


def onef1b_bubble(P: int, m: int, tc: float) -> float:
    num = 6 * (P - 1) + (2 * P + 4 * (m - 2)) * tc
    den = 6 * (P - 1 + m) + (2 * P + 4 * (m - 2)) * tc
    return num / den


# ---------------------------------------------------------------------------
# split-backward (zero-bubble family) closed forms
# ---------------------------------------------------------------------------

def zb_h1_bubble(P: int, m: int, f: float = 1.0, b_in: float = 1.0,
                 w: float = 1.0) -> float:
    """Ideal ZB-H1 steady-state bubble ratio at zero P2P cost (Qi et al.,
    *Zero Bubble Pipeline Parallelism*): per-stage idle is
    ``(P-1)(f + b_in - w)`` grains against ``(f + b_in + w) m`` of work.
    With the repo's grain convention (f = b_in = w = 1, i.e. the fused
    2-grain backward split in half) this is one third of 1F1B's
    ``3 (P-1)`` idle.  The constructed :func:`repro_torch.core.schedules.zb_h1`
    achieves this bound exactly for m >= P."""
    idle = (P - 1) * (f + b_in - w)
    work = (f + b_in + w) * m
    return idle / (idle + work)


# ---------------------------------------------------------------------------
# V-shape controllable-memory family (Qi et al. 2024) closed forms
# ---------------------------------------------------------------------------

def v_min_bubble_bound(P: int, m: int) -> float:
    """Upper bound on the constructed ``v_min`` bubble ratio.

    The just-in-time V-Min construction (6-grain cycle, 2 chunks,
    split backward) has zero steady-state bubble; all idle lives in the
    warm-up/cool-down ramp, whose per-device span is at most
    ``4P + 2`` grains (first F at grain 0 on device 0, last backward
    released at ``4P + δ`` with ``δ <= 2``) against ``6m`` grains of
    work.  This is the V-Min-class trade of *Pipeline Parallelism with
    Controllable Memory*: ~1/3 of 1F1B's activation for roughly ``4/3``
    of 1F1B's ``3(P-1)``-grain ramp."""
    idle = 4 * P + 2
    return idle / (idle + 6 * m)


def vshape_zb_bubble(P: int, m: int, f: float = 1.0, b_in: float = 1.0,
                     w: float = 1.0) -> float:
    """Ideal bubble of the eager V-shape schedule (``v_zb``): the
    ZB-H1 ramp ``(P-1)(f + b_in - w)`` against the V family's
    ``2(f + b_in + w) m`` grains of per-device work (two chunks per
    device).  The constructed :func:`repro_torch.core.vshape.v_zb` achieves
    this exactly for ``m >= P``."""
    idle = (P - 1) * (f + b_in - w)
    work = 2 * (f + b_in + w) * m
    return idle / (idle + work)


# ---------------------------------------------------------------------------
# executor tick-cost model
# ---------------------------------------------------------------------------

def predicted_tick_costs(sched, tab=None):
    """Analytic per-tick compute cost of the compiled lockstep table.

    The SPMD executor runs the task table one tick at a time with a
    collective barrier per tick, so the predicted wall-clock of tick
    ``t`` is the *maximum* scheduled duration (grains) over the devices'
    tasks at that tick — idle devices wait at the exchange.  Returns a
    float array ``[T]``; dividing a measured step by its sum gives the
    executor's effective grain time, which makes predicted-vs-measured
    tick cost comparable across schedule families (a family with more
    compute per tick is *expected* to take proportionally longer — the
    residual is executor overhead)."""
    from repro_torch.core.tasktable import (B_OPS, F_OPS, R_OPS, W_OPS,
                                            build_task_table)
    if tab is None:
        tab = build_task_table(sched)
    durs = {t.key(): t.dur for t in sched.tasks}
    kind_of = {}
    for ops, k in ((F_OPS, "F"), (B_OPS, "B"), (W_OPS, "W"),
                   (R_OPS, "R")):
        for o in ops:
            kind_of[o] = k
    out = []
    for t in range(tab.T):
        worst = 0.0
        for d in range(tab.P):
            op = int(tab.op[t, d])
            if op == 0:
                continue
            key = (kind_of[op], int(tab.mb[t, d]), int(tab.chunk[t, d]),
                   _stage_of(sched, d, int(tab.chunk[t, d])),
                   int(tab.seq[t, d]))
            worst = max(worst, durs[key])
        out.append(worst)
    return np.asarray(out)


def _stage_of(sched, device: int, chunk: int) -> int:
    """Inverse of the placement's (stage, chunk) -> device map."""
    return sched.pl.stage(device, chunk)


# ---------------------------------------------------------------------------
# byte-level memory model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MemoryModel:
    """Per-device memory terms (bytes) for one (model, parallelism) point.

    Activation accounting per token per layer (bf16), Megatron-style with
    FlashAttention + operator-level recompute (RMSNorm & activation
    function) as the paper's §6.1 default:
      attn-in residual 2h | qkv 2(h_q + 2 h_kv) | attn-out 2h |
      mlp-in residual 2h | gate+up 2*2*ff (gated) or up 2*ff
    Tensors divide by TP (sequence-parallel on for the residuals).
    """
    act_per_token_layer: float      # bytes, already / TP
    act_embed_head: float           # logits etc. (excluded from m_a)
    state_bytes_per_param: float    # full resident optimizer state
    params_per_layer: float
    params_embed: float
    # K+V bytes per token per layer (bf16, / TP; 0 for non-attention
    # layers, layer-kind-averaged) — the seqpipe KV-carry ring term
    kv_per_token_layer: float = 0.0

    @staticmethod
    def build(cfg: ModelConfig, tp: int = 1, sp: bool = True,
              state_bytes: float = 16.0) -> "MemoryModel":
        h = cfg.d_model
        hd = cfg.resolved_head_dim
        hq = cfg.num_heads * hd
        hkv = cfg.num_kv_heads * hd
        gated = cfg.act in ("silu", "geglu")
        # layer-kind-averaged activation bytes/token (full store)
        acts = []
        for i in range(cfg.num_layers):
            kind = cfg.layer_kind(i)
            a = 0.0
            a += 2 * h / (tp if sp else 1)          # attn-in residual
            if kind == "attn":
                a += BF16 * (hq + 2 * hkv) / tp     # qkv
                a += BF16 * hq / tp                 # flash-attn out
            else:
                s = cfg.ssm
                d_in = s.expand * h
                a += BF16 * (2 * d_in) / tp         # z, conv(x)
                a += BF16 * (2 * s.state_dim)       # B, C (replicated)
                a += 4 * (d_in // s.head_dim)       # dt (fp32)
                a += BF16 * d_in / tp               # ssd out (pre-gate)
            a += 2 * h / (tp if sp else 1)          # mlp-in residual
            if cfg.layer_is_moe(i):
                m = cfg.moe
                ff_act = m.top_k * m.d_ff_expert + \
                    m.num_shared_experts * m.d_ff_shared
                a += BF16 * (2 if gated else 1) * ff_act / tp
                a += 4 * m.num_experts              # router logits fp32
            elif cfg.d_ff and (kind == "attn" or cfg.ssm is None
                               or cfg.family == "hybrid"):
                a += BF16 * (2 if gated else 1) * cfg.d_ff / tp
            acts.append(a)
        act_mean = sum(acts) / max(len(acts), 1)
        emb = BF16 * cfg.vocab_size / tp            # logits/token
        n_layer = (cfg.param_count() - _embed_params(cfg)) / cfg.num_layers
        n_attn = sum(1 for i in range(cfg.num_layers)
                     if cfg.layer_kind(i) == "attn")
        kv_mean = (2 * BF16 * cfg.num_kv_heads * cfg.resolved_head_dim
                   / tp) * n_attn / max(cfg.num_layers, 1)
        return MemoryModel(act_mean, emb, state_bytes, n_layer,
                           _embed_params(cfg), kv_per_token_layer=kv_mean)

    # -- queries ------------------------------------------------------------
    def m_a(self, tokens_per_microbatch: int, num_layers: float) -> float:
        """Whole-net activation bytes for one microbatch (paper's m_a)."""
        return self.act_per_token_layer * tokens_per_microbatch * num_layers

    def kv_a(self, tokens_per_microbatch: int, num_layers: float) -> float:
        """Whole-net K/V bytes for one microbatch — the unit of the
        seqpipe KV-carry ring (full-sequence K/V per in-flight
        microbatch; the dKV twin doubles it at the call site)."""
        return self.kv_per_token_layer * tokens_per_microbatch * num_layers

    def model_state(self, num_layers: float, pp: int, tp: int,
                    dp_shard: int = 1,
                    offload_frac: float = 0.0,
                    offload_resident: float = 6.0) -> float:
        """Per-device model-state bytes.  ``offload_frac`` of layers keep
        only bf16 weight + fp32 grad on device (Chronos-Offload)."""
        per_layer = self.params_per_layer / (pp * tp * dp_shard)
        n = num_layers
        full = per_layer * n * (1 - offload_frac) * self.state_bytes_per_param
        off = per_layer * n * offload_frac * offload_resident
        emb = self.params_embed / tp * self.state_bytes_per_param / pp
        return full + off + emb


def _embed_params(cfg: ModelConfig) -> float:
    n = cfg.vocab_size * cfg.d_model
    return n if cfg.tie_embeddings else 2 * n


# ---------------------------------------------------------------------------
# max trainable model size (Fig. 9b)
# ---------------------------------------------------------------------------

def max_trainable_layers(cfg: ModelConfig, *, hbm_bytes: float, pp: int,
                         tp: int, microbatch_tokens: int,
                         act_frac_of_ma: float,
                         offload_frac: float = 0.0,
                         reserve: float = 2.0e9,
                         layer_step: int = 8,
                         memory_model: Optional[MemoryModel] = None) -> int:
    """Largest layer count trainable under ``hbm_bytes`` per device given a
    schedule's peak-activation fraction (units of m_a).  Pass
    ``memory_model`` to reuse a (possibly calibrated) estimator — e.g.
    a :class:`~repro_torch.plan.PlannerQuery`'s ``act_scale``."""
    mm = memory_model if memory_model is not None \
        else MemoryModel.build(cfg, tp=tp)
    best = 0
    L = layer_step
    while L <= 4096:
        # m_a is whole-net; the schedule's peak fraction already folds in
        # the 1/P distribution across stages.
        act = act_frac_of_ma * mm.m_a(microbatch_tokens, L)
        state = mm.model_state(L, pp, tp, offload_frac=offload_frac)
        if act + state + reserve <= hbm_bytes:
            best = L
            L += layer_step
        else:
            break
    return best


# ---------------------------------------------------------------------------
# Chronos-Offload (§5.1, Eq. 4-7, Fig. 14)
# ---------------------------------------------------------------------------

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
