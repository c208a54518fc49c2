"""Fused AdamW update kernel (CUDA) and its plain version."""
from repro_torch.kernels.fused_adamw.ops import (  # noqa: F401
    adamw_update_leaf, fused_adamw_flat, fused_adamw_flat_ref)
