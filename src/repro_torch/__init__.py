"""PyTorch/CUDA port of ``repro``: its pipelined serving path, its
ChronosPipe pipeline training step (with Chronos-Offload, the deepest
chunks' AdamW on the host) and its single-device training driver with
Chronos-Recomp, each on one device; the pipeline step also runs one
stage a ``torch.distributed`` rank (:mod:`repro_torch.launch.mesh`).

The package stands beside the JAX package ``repro`` and imports nothing
of it (nor JAX): every module it needs is its own copy.  Layout and
names mirror ``repro`` so each module's counterpart is easy to find
(``repro_torch/models/layers.py`` <-> ``repro/models/layers.py``).

Entry points (:mod:`repro_torch.launch.serve`,
:func:`repro_torch.launch.train.train`,
:func:`repro_torch.launch.train.train_pipeline`) run on CUDA unless the
caller passes ``device="cpu"``; a CUDA request on a machine without a
card raises instead of falling back.  The hand-written kernels (RMSNorm
rows, the flash-attention forward, the Mamba-2 SSD chunk scan, fused
AdamW) live in ``csrc/`` and are built by ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`); importing the package never builds.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (str or torch.device) -> torch.device; raises when CUDA
    is asked for and no card is visible (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
