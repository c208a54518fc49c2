"""Model configuration for the port (own copy of ``repro.configs.base``).

Only the dense-attention fields that serving reads are carried over;
MoE, SSM, encoder-decoder and VLM sub-configs arrive with the slices
that port those paths.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


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
    rope_theta: float = 10000.0
    # local/global attention mix: layers with idx % period in
    # ``global_offsets`` are global, the rest use ``sliding_window``.
    sliding_window: int = 0         # 0 -> full attention everywhere
    attn_pattern_period: int = 0
    global_offsets: Tuple[int, ...] = ()
    act: str = "silu"               # silu (swiglu) | gelu (plain) | geglu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def layer_kind(self, idx: int) -> str:
        """'attn' for every decoder layer (no SSM layers in the port yet)."""
        return "attn"

    def layer_is_global(self, idx: int) -> bool:
        """Full (global) attention for this layer? (vs sliding window)"""
        if self.sliding_window == 0:
            return True
        if not self.attn_pattern_period:
            return False
        return (idx % self.attn_pattern_period) in self.global_offsets

    @property
    def period(self) -> int:
        """Structural period of the decoder stack (layers stacked per
        period position)."""
        p = 1
        if self.attn_pattern_period:
            p = p * self.attn_pattern_period // math.gcd(
                p, self.attn_pattern_period)
        return p
