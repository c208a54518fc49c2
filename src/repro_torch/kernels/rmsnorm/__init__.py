"""RMSNorm rows kernel (CUDA), its plain version and the differentiable
call."""
from repro_torch.kernels.rmsnorm.ops import (  # noqa: F401
    RMSNormRows, rmsnorm_fused, rmsnorm_rows, rmsnorm_rows_ref)
