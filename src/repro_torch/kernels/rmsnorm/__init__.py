"""RMSNorm rows kernel (CUDA), its plain version and the differentiable
call; the split-width pair (a row's columns over tensor-parallel ranks)."""
from repro_torch.kernels.rmsnorm.ops import (  # noqa: F401
    RMSNormRows, RMSNormSplit, rmsnorm_fused, rmsnorm_rows, rmsnorm_rows_ref,
    rmsnorm_scale_rows, rmsnorm_scale_rows_ref, rmsnorm_split_fused,
    rmsnorm_sumsq_rows, rmsnorm_sumsq_rows_ref)
