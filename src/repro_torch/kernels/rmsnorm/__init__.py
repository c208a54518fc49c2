"""RMSNorm rows kernel (CUDA) and its plain version."""
from repro_torch.kernels.rmsnorm.ops import (  # noqa: F401
    rmsnorm_fused, rmsnorm_rows, rmsnorm_rows_ref)
