"""Configuration dataclasses for the port (own copy of
``repro.configs.base``).

Every model field is carried over: dense attention (with gemma3's
local/global sliding windows), Mamba-2 (SSD), mixture-of-experts, the
encoder-decoder (whisper) and the VLM patch prefix (paligemma).  ``ParallelPlan`` keeps the fields the single-card
pipeline step reads; mesh axes, ZeRO and wire compression arrive with
the multi-process slice (ROADMAP A.1d).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0            # per shared expert
    layer_period: int = 1           # MoE on layers where idx % period == offset
    layer_offset: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_len: int = 64             # SSD intra-chunk length
    # hybrid interleaving (jamba): attention on layers where
    # idx % attn_period == attn_offset; pure SSM if attn_period == 0.
    attn_period: int = 0
    attn_offset: int = 0


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (whisper-style) configuration.  The modality
    frontend (conv mel-spectrogram downsampling) is a stub: the caller
    hands in precomputed frame embeddings [batch, num_frames, d_model]."""
    num_encoder_layers: int
    num_frames: int = 1500          # whisper-base encoder positions


@dataclass(frozen=True)
class VisionStubConfig:
    """VLM (paligemma-style) frontend stub: precomputed patch embeddings
    [batch, num_patches, d_model] form a prefix that attends
    bidirectionally (prefix-LM masking)."""
    num_patches: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int                 # decoder layers
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                       # dense FFN hidden
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    qkv_bias: bool = False          # biases on the q, k, v projections
    rope_theta: float = 10000.0
    # local/global attention mix: layers with idx % period in
    # ``global_offsets`` are global, the rest use ``sliding_window``.
    sliding_window: int = 0         # 0 -> full attention everywhere
    attn_pattern_period: int = 0
    global_offsets: Tuple[int, ...] = ()
    act: str = "silu"               # silu (swiglu) | gelu (plain) | geglu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    family: str = "dense"           # dense | moe | hybrid | ssm | vlm | audio
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    vision: Optional[VisionStubConfig] = None
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.ssm is not None and self.ssm.attn_period == 0

    def layer_kind(self, idx: int) -> str:
        """'attn' | 'mamba' for decoder layer ``idx``."""
        if self.ssm is None:
            return "attn"
        s = self.ssm
        if s.attn_period and idx % s.attn_period == s.attn_offset:
            return "attn"
        return "mamba"

    def layer_is_global(self, idx: int) -> bool:
        """Full (global) attention for this layer? (vs sliding window)"""
        if self.sliding_window == 0:
            return True
        if not self.attn_pattern_period:
            return False
        return (idx % self.attn_pattern_period) in self.global_offsets

    def layer_is_moe(self, idx: int) -> bool:
        if self.moe is None:
            return False
        return idx % self.moe.layer_period == self.moe.layer_offset

    @property
    def period(self) -> int:
        """Structural period of the decoder stack (layers stacked per
        period position)."""
        p = 1
        if self.ssm is not None and self.ssm.attn_period:
            p = _lcm(p, self.ssm.attn_period)
        if self.moe is not None and self.moe.layer_period > 1:
            p = _lcm(p, self.moe.layer_period)
        if self.attn_pattern_period:
            p = _lcm(p, self.attn_pattern_period)
        return p

    def param_count(self) -> int:
        """Total parameter count (embedding included): the attention,
        Mamba-2, MoE, dense-FFN and norm terms of the decoder, plus an
        encoder-decoder config's encoder layers and the decoder's
        cross-attention (its projections and ``norm_x``)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d                               # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                          # lm head
        for i in range(self.num_layers):
            if self.layer_kind(i) == "attn":
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                n += q + kv + o
                if self.qkv_bias:
                    n += (self.num_heads + 2 * self.num_kv_heads) * hd
            else:  # mamba
                s = self.ssm
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                n += d * (2 * d_in + 2 * s.state_dim + nheads)   # in_proj
                n += s.conv_width * (d_in + 2 * s.state_dim)     # conv
                n += 2 * nheads + d_in                   # A, D, dt_bias, norm
                n += d_in * d                                    # out_proj
            if self.layer_is_moe(i):
                m = self.moe
                n += m.num_experts * 3 * d * m.d_ff_expert
                n += d * m.num_experts                           # router
                n += m.num_shared_experts * 3 * d * m.d_ff_shared
            elif self.d_ff:
                mult = 3 if self.act in ("silu", "geglu") else 2
                n += mult * d * self.d_ff
            n += 2 * d                                           # norms
        if self.encdec is not None:
            mult = 3 if self.act in ("silu", "geglu") else 2
            attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                    + self.num_heads * hd * d)
            n += self.encdec.num_encoder_layers * (attn + mult * d * self.d_ff
                                                   + 2 * d)
            n += self.num_layers * (attn + d)            # cross + norm_x
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        n = self.param_count()
        n_moe_layers = sum(1 for i in range(self.num_layers)
                           if self.layer_is_moe(i))
        inactive = n_moe_layers * (m.num_experts - m.top_k) * 3 * \
            self.d_model * m.d_ff_expert
        return n - inactive


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


# ---------------------------------------------------------------------------
# Shape config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


# ---------------------------------------------------------------------------
# Parallel plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RecomputeConfig:
    """Chronos-Recomp policy: which chunks are rematerialized and how."""
    mode: str = "none"              # none | chronos | uniform | full
    # chronos: recompute the ``num_recomp_chunks`` *shallowest* chunks
    num_recomp_chunks: int = 1
    # uniform: recompute this fraction of every layer (1F1B+R baseline)
    uniform_frac: float = 0.5
    # per-chunk policy when rematerializing: "full" drops everything,
    # "selective" keeps the projection outputs (Megatron-style).
    policy: str = "full"


@dataclass(frozen=True)
class OffloadConfig:
    """Chronos-Offload policy: optimizer step of the ``num_offload_chunks``
    *deepest* chunks runs on host (CPU DRAM holds master weights + momenta).
    ``pcie_gbps`` and ``cpu_flops`` are inputs of the Eq. (5)/(7) model
    (:func:`repro_torch.core.analysis.offload_timing`), the paper
    testbed's figures; nothing measures them."""
    enabled: bool = False
    num_offload_chunks: int = 1
    pcie_gbps: float = 32.0         # PCIe5 x8, per the paper's testbed
    cpu_flops: float = 2.0e12       # host SIMD throughput for the update


@dataclass(frozen=True)
class ParallelPlan:
    """Pipeline plan of one training run."""
    schedule: str = "chronos"       # pipeline schedule name (core.schedules)
    num_chunks: int = 2             # v
    seq_chunks: int = 1             # sequence chunks per microbatch
                                    # (repro_torch.seqpipe; >1 only for
                                    # the seq1f1b / chronos_seq schedules)
    num_microbatches: int = 0       # 0 -> global_batch // microbatch_size
    microbatch_size: int = 2        # sequences per microbatch
    recompute: RecomputeConfig = field(default_factory=RecomputeConfig)
    offload: OffloadConfig = field(default_factory=OffloadConfig)
    kernels: str = "plain"          # compute backend for the chunk body
                                    # (repro_torch.models.backend):
                                    # "plain" | "fused" (the CUDA rmsnorm,
                                    # flash and SSD-scan kernels + the
                                    # fused-AdamW update for
                                    # split-backward schedules)


# ---------------------------------------------------------------------------
# Train config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"        # cosine | linear | constant
    min_lr_ratio: float = 0.1


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    shape: ShapeConfig
    plan: ParallelPlan
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seed: int = 0
    log_every: int = 10
    checkpoint_every: int = 500
    # None: no checkpointer and no restore (the reference defaults to
    # "/tmp/repro_ckpt" and always restores from it; here a run touches
    # the disk only when asked to)
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
