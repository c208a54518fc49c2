"""Compute-backend seam (port of ``repro/models/backend.py``).

The layer body calls ``backend.rmsnorm`` and ``backend.flash``; the
backend, chosen by the ``kernels=`` flag, decides what runs:

- ``"fused"`` (the default): the hand-written CUDA kernels
  (:mod:`repro_torch.kernels`) — RMSNorm rows for every layer norm and the
  flash-attention forward for every prefill chunk.  On CPU tensors the
  kernel wrappers run their plain versions.
- ``"plain"`` (the reference's ``"xla"`` twin): plain PyTorch ops, never
  a kernel of this package.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
from repro_torch.models import layers as L


@dataclass(frozen=True)
class ComputeBackend:
    """One implementation of the layer body's kernel-backed ops."""
    name: str = "plain"
    fuse_rmsnorm: bool = False
    fuse_attention: bool = False

    def rmsnorm(self, params, x, eps: float = 1e-6):
        if not self.fuse_rmsnorm:
            return L.rmsnorm(params, x, eps)
        return rmsnorm_fused(x, params["scale"], eps)

    def flash(self, q, k, v, *, causal: bool, window: int, prefix: int,
              q_offset: int = 0):
        """q [B,S,H,d]; k,v [B,T,G,d]; ``q_offset`` a host int."""
        o, _ = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   prefix=prefix, q_offset=q_offset)
        return o


PLAIN = ComputeBackend("plain")
FUSED = ComputeBackend("fused", fuse_rmsnorm=True, fuse_attention=True)

_REGISTRY = {"plain": PLAIN, "fused": FUSED}


def get_backend(kernels=None) -> ComputeBackend:
    """Resolve a ``kernels=`` flag ("fused" | "plain" | ComputeBackend |
    None => fused) to a backend instance."""
    if kernels is None:
        return FUSED
    if isinstance(kernels, ComputeBackend):
        return kernels
    try:
        return _REGISTRY[kernels]
    except KeyError:
        raise ValueError(f"unknown kernels flag {kernels!r}: expected "
                         f"{sorted(_REGISTRY)}") from None
