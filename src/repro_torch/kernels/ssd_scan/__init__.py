"""Mamba-2 SSD chunk-scan kernel (CUDA), its plain versions and the
differentiable call."""
from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    SSDScan, ssd, ssd_chunked_ref, ssd_reference, ssd_scan, ssd_scan_route)
