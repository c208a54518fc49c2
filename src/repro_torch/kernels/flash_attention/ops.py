"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Replaces ``src/repro/kernels/flash_attention/kernel.py::
flash_attention_fwd`` in both its static-offset (``_fwd_kernel``) and
dynamic-offset (``_fwd_kernel_dyn``) forms, reached through
``ops.py::flash_attention`` / ``flash_attention_dyn``.  The kernel is
``csrc/flash_attention.cu``; ``q_offset``, ``window`` and ``prefix`` are
launch arguments and the KV head ``h // (H // G)`` is indexed in place.
bf16 inputs take a FlashAttention-2 forward on the tensor cores
(``mma.sync`` m16n8k16, fp32 accumulators): 16 q rows per warp, K/V tiles
of 64 rows kept bf16 in a two-stage ``cp.async`` ring, online softmax in
fp32 registers, P rounded to bf16 only as the operand of P V (the running
sum adds the fp32 p, so ``lse`` keeps fp32 accuracy).  At head dim 256
(paligemma-3b) the CTA stages its Q tile in shared memory and reads each
k16 step's fragment by ``ldmatrix``, over K/V tiles of 32 rows, so that
the fp32 O accumulators keep their 128 registers a lane.  Its bound at the
training shape is the tensor cores' rate, at the serving shape latency.
fp32 inputs (checks only) take an fp32 CUDA-core kernel, as the TPU
kernel computes in fp32.

:func:`flash_attention_fwd` runs :func:`attention_ref` only for tensors
on the CPU; for meta tensors it returns empty outputs of the right
shapes and types; for CUDA tensors it launches the kernel or raises,
also for a q, k or v that is not 16-byte aligned (``cp.async`` copies
16-byte chunks).  ``flash_attention_fwd.launches`` counts kernel
launches.  Under :func:`repro_torch.roofline.count_work` a call counts
as ``kernel_cost("flash_attention_fwd", ...)`` (the visible pairs' work),
its body's ops hidden.

:func:`flash_attention` is the static-offset ``jax.custom_vjp`` of
``repro/kernels/flash_attention/ops.py`` as a ``torch.autograd.Function``
(:class:`FlashAttention`): the forward is the kernel, it saves only q, k
and v, and the backward recomputes :func:`attention_ref` under autograd
(flash-style recompute-from-(q, k, v); a dedicated backward kernel is a
later optimisation, as it is on the TPU).  The dynamic-offset form
(seqpipe's dKV carry) arrives with the seqpipe slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.roofline import analysis as roofline

NEG_INF = -2.0 ** 30
HEAD_DIMS = (16, 32, 64, 128, 256)


def attention_ref(q, k, v, *, scale=None, causal=True, window=0, prefix=0,
                  q_offset=0):
    """Plain mirror of ``kernels/flash_attention/ref.py::attention_ref``.
    q [B,Sq,H,d]; k,v [B,Sk,G,d].  Returns (o [B,Sq,H,d], lse [B,H,Sq])."""
    B, Sq, H, d = q.shape
    Sk, G = k.shape[1], k.shape[2]
    rep = H // G
    scale = scale or 1.0 / math.sqrt(d)
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = k_pos <= q_pos
    if prefix:
        ok = ok | (k_pos < prefix)
    if window:
        ok = ok & (q_pos - k_pos < window)
    s = torch.where(ok[None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l[..., None].clamp_min(1e-30),
                     vr.float())
    lse = m + torch.log(l.clamp_min(1e-30))
    return o.to(q.dtype), lse


def flash_attention_fwd(q, k, v, *, scale=None, causal=True, window=0,
                        prefix=0, q_offset=0):
    """q [B,Sq,H,d]; k,v [B,Sk,G,d] (H % G == 0).  ``q_offset``, ``window``
    and ``prefix`` are host ints.  Returns (o [B,Sq,H,d] in q's type,
    lse [B,H,Sq] fp32)."""
    if roofline.ACTIVE is not None:
        B, Sq, H, d = q.shape
        return roofline.kernel(
            "flash_attention_fwd", lambda: _flash_attention_fwd(
                q, k, v, scale, causal, window, prefix, q_offset),
            B=B, Sq=Sq, Sk=k.shape[1], H=H, G=k.shape[2], d=d,
            itemsize=q.element_size(), causal=causal, window=window,
            prefix=prefix, q_offset=q_offset)
    return _flash_attention_fwd(q, k, v, scale, causal, window, prefix,
                                q_offset)


def _flash_attention_fwd(q, k, v, scale, causal, window, prefix, q_offset):
    devs = {q.device, k.device, v.device}
    if devs == {torch.device("cpu")}:
        # o in the kernel's layout (the plain einsum's is permuted), so
        # the ops after it run alike on the CPU, the card and meta
        o, lse = attention_ref(q, k, v, scale=scale, causal=causal,
                               window=window, prefix=prefix,
                               q_offset=q_offset)
        return o.contiguous(), lse
    if devs == {torch.device("meta")}:
        return torch.empty_like(q), torch.empty(
            (q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
            device=q.device)
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: q/k/v on "
                         f"{sorted(map(str, devs))}; all must be on one CUDA "
                         "device (or all on the CPU)")
    dt = str(q.dtype).removeprefix("torch.")
    if dt not in build.DTYPE_CODES or {k.dtype, v.dtype} != {q.dtype}:
        raise ValueError(f"flash_attention_fwd: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; need one of float32, bfloat16 for all")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_fwd: need q [B,Sq,H,d] and "
                         "k, v [B,Sk,G,d] of one shape")
    B, Sq, H, d = q.shape
    Sk, G = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or G == 0 or H % G:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} disagree (need H % G == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k, v must be contiguous")
    if Sq == 0 or Sk == 0 or B == 0:
        raise ValueError("flash_attention_fwd: empty q or kv")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} is not 16-byte "
                             "aligned (the kernel copies 16-byte chunks)")
    lib = build.load_library()
    scale = scale or 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, H, G, d, float(scale), int(bool(causal)),
        int(window), int(prefix), int(q_offset), build.DTYPE_CODES[dt],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Kernel forward (output only), reference-recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, prefix, q_offset)
        o, _ = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   prefix=prefix, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window, prefix, q_offset = ctx.mask
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(need) for a, need in
                   zip((q, k, v), ctx.needs_input_grad[:3])]
            o, _ = attention_ref(*ins, causal=causal, window=window,
                                 prefix=prefix, q_offset=q_offset)
            wrt = [a for a in ins if a.requires_grad]
            grads = iter(torch.autograd.grad(o, wrt, do))
        return tuple(next(grads) if a.requires_grad else None
                     for a in ins) + (None,) * 4


def flash_attention(q, k, v, causal=True, window=0, prefix=0, q_offset=0):
    """q [B,Sq,H,d]; k,v [B,Sk,G,d]; mask parameters are host ints.
    Returns o [B,Sq,H,d] in q's type, differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, causal, int(window), int(prefix),
                                int(q_offset))
