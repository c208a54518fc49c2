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

Split-width rows (a row's columns cut over tensor-parallel ranks, the
Mamba-2 gated norm under tp): :func:`rmsnorm_sumsq_rows` (each row's
fp32 sum of squares over the columns here) and :func:`rmsnorm_scale_rows`
(the normalized row from the all-reduced sums), ``rmsnorm_sumsq_kernel``
and ``rmsnorm_scale_kernel`` of ``csrc/rmsnorm.cu`` on the card, their
plain versions :func:`rmsnorm_sumsq_rows_ref` and
:func:`rmsnorm_scale_rows_ref` on the CPU; :class:`RMSNormSplit` joins
them around the caller's all-reduce.  No library call takes a partial
sum of squares.
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


# ---------------------------------------------------------------------------
# split-width rows: the row's columns on several ranks (tensor parallelism)
# ---------------------------------------------------------------------------

def rmsnorm_sumsq_rows_ref(x):
    """Plain version of the first pass: each row's fp32 sum of squares over
    the columns ``x`` holds."""
    return x.float().square().sum(dim=-1)


def rmsnorm_scale_rows_ref(x, ss, scale, d_full: int, eps: float = 1e-6):
    """Plain version of the second pass: ``(x * rsqrt(ss / d_full + eps)) *
    scale`` in x's type, ``ss`` the fp32 sums of squares of the whole rows
    (all their columns, over every rank)."""
    inv = torch.rsqrt(ss / d_full + eps)[..., None]
    return ((x.float() * inv) * scale.float()).to(x.dtype)


def _check_rows(what, x, *others):
    """The wrappers' checks: CUDA tensors on one device, x [R, d]
    contiguous in float32 or bfloat16."""
    if x.device.type != "cuda" or any(o.device != x.device for o in others):
        raise ValueError(f"{what}: x on {x.device}, the others on "
                         f"{[str(o.device) for o in others]}; all must be on "
                         "one CUDA device (or all on the CPU)")
    dt = str(x.dtype).removeprefix("torch.")
    if dt not in build.DTYPE_CODES:
        raise ValueError(f"{what}: x {x.dtype}; need float32 or bfloat16")
    if x.dim() != 2 or not all(a.is_contiguous() for a in (x,) + others):
        raise ValueError(f"{what}: x {tuple(x.shape)} must be [R, d] and "
                         "every operand contiguous")
    return build.DTYPE_CODES[dt]


def rmsnorm_sumsq_rows(x):
    """x [R, d] -> fp32 [R]: each row's sum of squares over its columns
    here (``csrc/rmsnorm.cu`` ``rmsnorm_sumsq_kernel`` on the card).
    ``rmsnorm_sumsq_rows.launches`` counts launches."""
    if roofline.ACTIVE is not None:
        return roofline.kernel(
            "rmsnorm_sumsq_rows", lambda: _rmsnorm_sumsq_rows(x),
            R=x.numel() // max(x.shape[-1], 1), d=x.shape[-1],
            itemsize=x.element_size())
    return _rmsnorm_sumsq_rows(x)


def _rmsnorm_sumsq_rows(x):
    if x.device.type == "cpu":
        return rmsnorm_sumsq_rows_ref(x)
    if x.device.type == "meta":
        return torch.empty(x.shape[:-1], dtype=torch.float32, device="meta")
    code = _check_rows("rmsnorm_sumsq_rows", x)
    ss = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return ss
    lib = build.load_library()
    err = lib.rmsnorm_sumsq_launch(
        x.data_ptr(), ss.data_ptr(), x.shape[0], x.shape[1], code,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "rmsnorm_sumsq_rows")
    rmsnorm_sumsq_rows.launches += 1
    return ss


rmsnorm_sumsq_rows.launches = 0


def rmsnorm_scale_rows(x, ss, scale, d_full: int, eps: float = 1e-6):
    """x [R, d], ss fp32 [R] (the whole rows' sums of squares), scale [d]
    -> [R, d] in x's type (``csrc/rmsnorm.cu`` ``rmsnorm_scale_kernel`` on
    the card).  ``rmsnorm_scale_rows.launches`` counts launches."""
    if roofline.ACTIVE is not None:
        return roofline.kernel(
            "rmsnorm_scale_rows",
            lambda: _rmsnorm_scale_rows(x, ss, scale, d_full, eps),
            R=x.numel() // max(x.shape[-1], 1), d=x.shape[-1],
            itemsize=x.element_size())
    return _rmsnorm_scale_rows(x, ss, scale, d_full, eps)


def _rmsnorm_scale_rows(x, ss, scale, d_full, eps):
    if x.device.type == "cpu" and ss.device.type == "cpu" \
            and scale.device.type == "cpu":
        return rmsnorm_scale_rows_ref(x, ss, scale, d_full, eps)
    if x.device.type == "meta":
        return torch.empty_like(x)
    code = _check_rows("rmsnorm_scale_rows", x, ss, scale)
    if scale.dtype != x.dtype or ss.dtype != torch.float32 \
            or scale.shape != (x.shape[1],) or ss.shape != (x.shape[0],) \
            or d_full < x.shape[1]:
        raise ValueError(f"rmsnorm_scale_rows: x {tuple(x.shape)} {x.dtype}, "
                         f"ss {tuple(ss.shape)} {ss.dtype}, scale "
                         f"{tuple(scale.shape)} {scale.dtype}, d_full "
                         f"{d_full}: need ss fp32 [R], scale [d] in x's "
                         "type, d_full >= d")
    y = torch.empty_like(x)
    if x.shape[0] == 0:
        return y
    lib = build.load_library()
    err = lib.rmsnorm_scale_launch(
        x.data_ptr(), ss.data_ptr(), scale.data_ptr(), y.data_ptr(),
        x.shape[0], x.shape[1], int(d_full), float(eps), code,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "rmsnorm_scale_rows")
    rmsnorm_scale_rows.launches += 1
    return y


rmsnorm_scale_rows.launches = 0


class RMSNormSplit(torch.autograd.Function):
    """RMSNorm of rows whose columns are cut over ranks: ``x`` [R, d] holds
    this rank's ``d`` of the row's ``d_full`` columns, ``scale`` [d] its
    part of the scale, and ``all_reduce(t)`` sums an fp32 tensor over the
    row's ranks in place.  Forward: :func:`rmsnorm_sumsq_rows`, the
    all-reduce of the ``[R]`` sums, :func:`rmsnorm_scale_rows`.  Backward
    (plain, fp32): with ``inv = rsqrt(ss / d_full + eps)`` and ``gs = dy *
    scale``, ``dx = inv * gs - x * inv^3 * sum(gs * x) / d_full``, where
    the row's ``sum(gs * x)`` over all its columns is one more all-reduce
    of ``[R]`` fp32; ``dscale = sum_rows(dy * x * inv)``."""

    @staticmethod
    def forward(ctx, x, scale, eps, d_full, all_reduce):
        ss = rmsnorm_sumsq_rows(x)
        all_reduce(ss)
        ctx.save_for_backward(x, scale, ss)
        ctx.eps, ctx.d_full, ctx.all_reduce = eps, d_full, all_reduce
        return rmsnorm_scale_rows(x, ss, scale, d_full, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale, ss = ctx.saved_tensors
        x32, g = x.float(), dy.float()
        inv = torch.rsqrt(ss / ctx.d_full + ctx.eps)[:, None]
        gs = g * scale.float()
        dx = dscale = None
        if ctx.needs_input_grad[0]:
            dot = (gs * x32).sum(dim=-1).contiguous()
            ctx.all_reduce(dot)
            dx = (inv * gs - x32 * (inv ** 3) * (dot / ctx.d_full)[:, None]
                  ).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dscale = (g * (x32 * inv)).sum(dim=0).to(scale.dtype)
        return dx, dscale, None, None, None


def rmsnorm_split_fused(x, scale, d_full: int, all_reduce,
                        eps: float = 1e-6):
    """Any leading shape: rows of the last axis, their columns cut over
    ranks, through :class:`RMSNormSplit` (the kernel pair's forward,
    differentiable)."""
    shape = x.shape
    y = RMSNormSplit.apply(x.reshape(-1, shape[-1]), scale, eps, d_full,
                           all_reduce)
    return y.reshape(shape)


def rmsnorm_fused(x, scale, eps: float = 1e-6):
    """Any leading shape: rows of the last axis through
    :class:`RMSNormRows` (the kernel forward, differentiable)."""
    shape = x.shape
    y = RMSNormRows.apply(x.reshape(-1, shape[-1]), scale, eps)
    return y.reshape(shape)
