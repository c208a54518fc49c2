"""Fused AdamW update: the CUDA kernel's wrapper and its plain version.

Replaces ``src/repro/kernels/fused_adamw/kernel.py::fused_adamw_flat``
(body ``_kernel``), reached through ``ops.py::adamw_update_leaf`` when
``adamw_update(..., use_kernel=True)``.  The kernel is
``csrc/fused_adamw.cu``: one grid-stride pass over the flat leaf that
reads g, mu, nu and w once and writes mu, nu and w once, **in place**
(the reference returns new arrays; here a functional update would hold
the old and new optimizer state side by side — 3.3 GB for tinyllama's
stacked ``wi`` leaf alone).  It is bound by memory: 28 bytes per element
with fp32 g.  Every operation rounds once and none is contracted into an
FMA, so on the card the kernel equals :func:`fused_adamw_flat_ref`
bitwise.

``scalars`` is a 3-float tensor ``[lr, bc1, bc2]`` on the leaf's device
(the TPU kernel's SMEM scalars), computed there from the device step
counter, so the update needs no host sync.

:func:`fused_adamw_flat` runs the plain version only for tensors on the
CPU; for meta tensors it returns the state as it is; for CUDA tensors it
launches the kernel or raises.  ``fused_adamw_flat.launches`` counts
kernel launches.  Under :func:`repro_torch.roofline.count_work` a call
counts as ``kernel_cost("fused_adamw_flat", ...)``, its body's ops
hidden.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.roofline import analysis as roofline


def fused_adamw_flat_ref(g, mu, nu, w, scalars, *, b1, b2, eps, wd):
    """Plain PyTorch version, in place, in the kernel's operation order:
    every op is its own elementwise pass, so each result rounds once.
    ``scalars`` stays a device tensor: ``x / bc`` is then a true
    division (a host scalar divisor may become a multiply by its
    reciprocal on the card)."""
    lr, bc1, bc2 = scalars[0], scalars[1], scalars[2]
    g = g.float()
    mu.mul_(b1).add_(g * (1 - b1))
    nu.mul_(b2).add_(g * (1 - b2) * g)
    upd = (mu / bc1).div_((nu / bc2).sqrt_().add_(eps))
    upd.add_(w * wd)
    w.sub_(upd.mul_(lr))
    return mu, nu, w


def _check(g, mu, nu, w, scalars):
    devs = {t.device for t in (g, mu, nu, w, scalars)}
    if len(devs) != 1 or g.device.type != "cuda":
        raise ValueError(f"fused_adamw_flat: tensors on "
                         f"{sorted(map(str, devs))}; all must be on one CUDA "
                         "device (or all on the CPU)")
    n = w.numel()
    for name, t in (("mu", mu), ("nu", nu), ("w", w)):
        if t.dtype != torch.float32 or t.dim() != 1 or t.numel() != n:
            raise ValueError(f"fused_adamw_flat: {name} {t.dtype} "
                             f"{tuple(t.shape)}; need float32 [{n}]")
    dt = str(g.dtype).removeprefix("torch.")
    if dt not in build.DTYPE_CODES or g.shape != w.shape:
        raise ValueError(f"fused_adamw_flat: g {g.dtype} {tuple(g.shape)}; "
                         f"need float32 or bfloat16 [{n}]")
    if scalars.dtype != torch.float32 or scalars.shape != (3,):
        raise ValueError("fused_adamw_flat: scalars must be float32 [3] "
                         "(lr, bc1, bc2)")
    if not all(t.is_contiguous() for t in (g, mu, nu, w, scalars)):
        raise ValueError("fused_adamw_flat: inputs must be contiguous")
    return dt, n


def fused_adamw_flat(g, mu, nu, w, scalars, *, b1, b2, eps, wd):
    """All flat [n]: g fp32 or bf16; mu, nu, w fp32, updated in place and
    returned.  ``b1``, ``b2``, ``eps``, ``wd`` are host floats."""
    if roofline.ACTIVE is not None:
        return roofline.kernel(
            "fused_adamw_flat", lambda: _fused_adamw_flat(
                g, mu, nu, w, scalars, b1, b2, eps, wd),
            n=w.numel(), g_itemsize=g.element_size())
    return _fused_adamw_flat(g, mu, nu, w, scalars, b1, b2, eps, wd)


def _fused_adamw_flat(g, mu, nu, w, scalars, b1, b2, eps, wd):
    ins = (g, mu, nu, w, scalars)
    if all(t.device.type == "cpu" for t in ins):
        return fused_adamw_flat_ref(g, mu, nu, w, scalars, b1=b1, b2=b2,
                                    eps=eps, wd=wd)
    if all(t.device.type == "meta" for t in ins):
        return mu, nu, w
    dt, n = _check(g, mu, nu, w, scalars)
    lib = build.load_library()
    err = lib.fused_adamw_launch(
        g.data_ptr(), mu.data_ptr(), nu.data_ptr(), w.data_ptr(),
        scalars.data_ptr(), n, float(b1), float(1 - b1), float(b2),
        float(1 - b2), float(eps), float(wd), build.DTYPE_CODES[dt],
        torch.cuda.current_stream(w.device).cuda_stream)
    build.check(lib, err, "fused_adamw_flat")
    fused_adamw_flat.launches += 1
    return mu, nu, w


fused_adamw_flat.launches = 0


def adamw_update_leaf(g, mu, nu, w, scalars, *, b1, b2, eps, wd):
    """Shape-preserving fused update of one leaf (in place): the step
    :func:`repro_torch.optim.adamw.adamw_update` takes with
    ``use_kernel=True``."""
    fused_adamw_flat(g.reshape(-1), mu.view(-1), nu.view(-1), w.view(-1),
                     scalars, b1=b1, b2=b2, eps=eps, wd=wd)
    return mu, nu, w
