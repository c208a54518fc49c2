"""Flash-attention forward kernel (CUDA) and its plain version."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    attention_ref, flash_attention_fwd)
