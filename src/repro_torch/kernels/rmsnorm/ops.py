"""RMSNorm over rows: the CUDA kernel's wrapper and its plain version.

Replaces ``src/repro/kernels/rmsnorm/kernel.py::rmsnorm_rows`` (body
``_kernel``), reached through ``ops.py::rmsnorm_fused``.  The kernel is
``csrc/rmsnorm.cu``: one to eight warps per row read it with 16-byte
loads into registers, reduce the fp32 sum of squares with warp shuffles
(and shared memory across the row's warps), then write
``(x * rsqrt(mean + eps)) * scale``, cast to the input type, from those
registers with 16-byte stores.  It is bound by memory
(``2 * R * d * bytes + d * bytes``), and device memory sees each byte of
x once.  A row whose width is not a multiple of the 16-byte vector (or
too wide for the registers) takes the kernel's scalar loop instead.

:func:`rmsnorm_rows` runs the plain version :func:`rmsnorm_rows_ref` only
for tensors on the CPU; for meta tensors it returns an empty output of
the right shape and type; for CUDA tensors it launches the kernel or
raises.  ``rmsnorm_rows.launches`` counts kernel launches.  Under
:func:`repro_torch.roofline.count_work` a call counts as
``kernel_cost("rmsnorm_rows", ...)``, its body's ops hidden.

:class:`RMSNormRows` mirrors the reference's ``jax.custom_vjp``
(``repro/kernels/rmsnorm/ops.py``): the forward is :func:`rmsnorm_rows`
(the kernel on the card), the backward differentiates
:func:`rmsnorm_rows_ref` under autograd — the same math, so gradients
equal the plain backend's.  :func:`rmsnorm_fused` goes through it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.roofline import analysis as roofline


def rmsnorm_rows_ref(x, scale, eps: float = 1e-6):
    """Plain PyTorch mirror of ``models/layers.py::rmsnorm`` on rows."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm_rows(x, scale, eps: float = 1e-6):
    """x [R, d]; scale [d] -> [R, d] in x's type."""
    if roofline.ACTIVE is not None:
        return roofline.kernel(
            "rmsnorm_rows", lambda: _rmsnorm_rows(x, scale, eps),
            R=x.numel() // max(x.shape[-1], 1), d=x.shape[-1],
            itemsize=x.element_size())
    return _rmsnorm_rows(x, scale, eps)


def _rmsnorm_rows(x, scale, eps):
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_rows_ref(x, scale, eps)
    if x.device.type == "meta" and scale.device.type == "meta":
        return torch.empty_like(x)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm_rows: x on {x.device}, scale on "
                         f"{scale.device}; both must be on one CUDA device "
                         "(or both on the CPU)")
    dt = str(x.dtype).removeprefix("torch.")
    if dt not in build.DTYPE_CODES or scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm_rows: x {x.dtype} / scale {scale.dtype}; "
                         "need float32 or bfloat16, the same for both")
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_rows: x {tuple(x.shape)} must be [R, d] "
                         f"and scale {tuple(scale.shape)} [d]")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_rows: x and scale must be contiguous")
    lib = build.load_library()
    R, d = x.shape
    y = torch.empty_like(x)
    if R == 0:
        return y
    err = lib.rmsnorm_rows_launch(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), R, d, float(eps),
        build.DTYPE_CODES[dt],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "rmsnorm_rows")
    rmsnorm_rows.launches += 1
    return y


rmsnorm_rows.launches = 0


class RMSNormRows(torch.autograd.Function):
    """Kernel forward, plain-version backward (saves x and scale)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_rows(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(ctx.needs_input_grad[0])
            s_ = scale.detach().requires_grad_(ctx.needs_input_grad[1])
            y = rmsnorm_rows_ref(x_, s_, ctx.eps)
            wrt = [a for a in (x_, s_) if a.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, dy))
        return (next(grads) if x_.requires_grad else None,
                next(grads) if s_.requires_grad else None, None)


def rmsnorm_fused(x, scale, eps: float = 1e-6):
    """Any leading shape: rows of the last axis through
    :class:`RMSNormRows` (the kernel forward, differentiable)."""
    shape = x.shape
    y = RMSNormRows.apply(x.reshape(-1, shape[-1]), scale, eps)
    return y.reshape(shape)
