"""Flash-attention forward kernel (CUDA), its plain version and the
differentiable static-offset call."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    FlashAttention, attention_ref, flash_attention, flash_attention_fwd)
