"""Mamba-2 SSD chunk scan: the CUDA kernel's wrapper and its plain versions.

Replaces ``src/repro/kernels/ssd_scan/kernel.py::ssd_scan`` (body
``_kernel``), reached through ``ops.py::ssd`` on the fused backend's
training path (``ComputeBackend.ssd`` with no carried state).  The port's
kernel also takes a carried fp32 state ``h0`` (serving's prefill chunks),
which the reference sends to its XLA ``_ssd_chunked`` instead.  The kernels
are in ``csrc/ssd_scan.cu``, bound by bytes (x in, y out in fp32).  The
route is chosen by dtype (:func:`ssd_scan_route`): bf16 x, B and C take
three tensor-core passes (each chunk's state contribution, the carry over
the chunks, then each chunk's output), with an fp32 state scratch the
wrapper allocates; fp32 inputs take the CUDA-core kernel, one CTA per
(batch * head, 16 head-dim columns) looping over the chunks.  B and C are
indexed by batch, never copied per head.

- :func:`ssd_chunked_ref` is the plain version, a copy of
  ``repro/models/mamba.py::_ssd_chunked`` (zero-pad to a chunk multiple,
  optional carried state ``h0``; the reference's ``lax.scan`` becomes
  batched terms and a loop over the carried state only).
- :func:`ssd_reference` is the sequential recurrence, the oracle of the
  tests.
- :func:`ssd_scan` runs :func:`ssd_chunked_ref` only for tensors on the
  CPU; for meta tensors it returns empty outputs of the right shapes;
  for CUDA tensors it launches its route's kernels or raises.
  ``ssd_scan.launches`` counts its calls that launched (one per scan,
  whatever the route); :data:`ROUTE_KERNELS` names the kernels each route
  runs, by which a profile tells the routes apart.  Under
  :func:`repro_torch.roofline.count_work` a call counts as
  ``kernel_cost("ssd_scan", ...)``, its body's ops hidden.
- :class:`SSDScan` mirrors the reference's ``jax.custom_vjp``: the forward
  pads and runs :func:`ssd_scan`, saving only x, B, C, dt, A and h0; the
  backward recomputes :func:`ssd_chunked_ref` under autograd (the
  reference has no backward kernel either), so its gradients, h0's too,
  equal autograd through the plain version.  :func:`ssd` goes through
  it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.roofline import analysis as roofline

MAX_CHUNK = 128            # csrc/ssd_scan.cu kMaxQ
MAX_STATE = 256            # csrc/ssd_scan.cu kMaxN

TENSOR_CORES = "tensor_cores"
CUDA_CORES = "cuda_cores"
ROUTE_KERNELS = {
    TENSOR_CORES: ("ssd_scan_kernel_states", "ssd_scan_kernel_pass",
                   "ssd_scan_kernel_out"),
    CUDA_CORES: ("ssd_scan_kernel",),
}


def ssd_scan_route(dtype: torch.dtype) -> str:
    """The kernels a scan of x, B and C in ``dtype`` runs on the card:
    bf16 takes the tensor-core passes, fp32 the CUDA-core kernel."""
    if dtype == torch.bfloat16:
        return TENSOR_CORES
    if dtype == torch.float32:
        return CUDA_CORES
    raise ValueError(f"ssd_scan: no kernel for {dtype}")


def _pad_to_chunk(x, Bc, Cc, dt, chunk: int):
    """Zero-pad the sequence axis to a multiple of ``min(chunk, S)``:
    dt = 0 rows decay by exp(0) = 1 and add nothing, so the padded steps
    leave the state as it is.  Returns the padded tensors and the old S."""
    S = x.shape[1]
    pad = (-S) % min(chunk, S)
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    return x, Bc, Cc, dt, S


def ssd_chunked_ref(xh, Bc, Cc, dt, A, chunk: int, h0=None):
    """xh [B,S,H,P]; Bc,Cc [B,S,N]; dt [B,S,H] (fp32, post-softplus);
    A [H] (negative, fp32).  Returns y [B,S,H,P], h_final [B,H,P,N] (fp32).

    Each chunk does the reference's arithmetic.  The reference's
    ``lax.scan`` body is split: every term that does not read the carried
    state (the decay matrix, the intra-chunk product, each chunk's state
    contribution) is computed for all chunks at once; the carry
    ``h <- exp(cum_end) h + add`` stays a loop over chunks, and the
    inter-chunk term reads the stacked states the loop saw.  Eagerly,
    a loop over whole chunk bodies would launch ~20 ops per chunk (and
    twice that again in the backward) where this launches ~20 in all.
    The decay matrix masks the segment sums above the diagonal to -inf
    before the exponential, where the reference exponentiates first and
    then selects: the values are the same, and the gradient stays finite
    where ``exp`` of an unselected entry would overflow."""
    Bsz, H, P = xh.shape[0], xh.shape[2], xh.shape[3]
    N = Bc.shape[-1]
    xh, Bc, Cc, dt, S0 = _pad_to_chunk(xh, Bc, Cc, dt, chunk)
    S = xh.shape[1]
    Q = min(chunk, S0)
    nc = S // Q
    xc = xh.reshape(Bsz, nc, Q, H, P).float()
    Bb = Bc.reshape(Bsz, nc, Q, N).float()
    Cb = Cc.reshape(Bsz, nc, Q, N).float()
    dtb = dt.reshape(Bsz, nc, Q, H)
    above = ~torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()

    a = dtb * A                                           # [B,c,Q,H]
    cum = torch.cumsum(a, dim=2)                          # inclusive
    # intra-chunk (dual quadratic form)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,c,Q,Q,H]
    L = torch.exp(seg.masked_fill(above[:, :, None], float("-inf")))
    L = L * dtb[:, :, None, :, :]                         # decay * dt_j
    cb = torch.einsum("bcqn,bckn->bcqk", Cb, Bb)          # [B,c,Q,Q]
    scores = cb[..., None] * L                            # [B,c,Q,Q,H]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)
    # each chunk's contribution to the state, and its decay
    dec_to_end = torch.exp(cum[:, :, -1:, :] - cum) * dtb
    add = torch.einsum("bckh,bckn,bckhp->bchpn", dec_to_end, Bb, xc)
    decay = torch.exp(cum[:, :, -1])[..., None, None]     # [B,c,H,1,1]
    # the carry: the state each chunk starts from
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, c] * h + add[:, c]
    # inter-chunk from the carried state
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bcqn,bchpn->bcqhp", Cb, torch.stack(h_in, dim=1))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y[:, :S0], h


def ssd_reference(xh, Bc, Cc, dt, A, h0=None):
    """Naive sequential recurrence (``repro/models/mamba.py::
    ssd_reference``): the oracle of the tests."""
    Bsz, S, H, P = xh.shape
    N = Bc.shape[-1]
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A)                          # [B,H]
        add = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], Bc[:, t].float(),
                           xh[:, t].float())
        h = a[:, :, None, None] * h + add
        ys.append(torch.einsum("bn,bhpn->bhp", Cc[:, t].float(), h))
    return torch.stack(ys, dim=1), h


def _check(x, Bc, Cc, dt, A, Q, h0=None):
    devs = {t.device for t in (x, Bc, Cc, dt, A)
            + (() if h0 is None else (h0,))}
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(f"ssd_scan: tensors on {sorted(map(str, devs))}; "
                         "all must be on one CUDA device (or all on the CPU)")
    dt_name = str(x.dtype).removeprefix("torch.")
    if dt_name not in build.DTYPE_CODES or {Bc.dtype, Cc.dtype} != {x.dtype}:
        raise ValueError(f"ssd_scan: x {x.dtype}, B {Bc.dtype}, C "
                         f"{Cc.dtype}; need float32 or bfloat16, the same "
                         "for all three")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt {dt.dtype} and A {A.dtype} must be "
                         "float32")
    if x.dim() != 4 or Bc.dim() != 3:
        raise ValueError(f"ssd_scan: need x [B,S,H,P] and B, C [B,S,N]; got "
                         f"x {tuple(x.shape)}, B {tuple(Bc.shape)}")
    Bsz, S, H, P = x.shape
    N = Bc.shape[-1]
    if (Bc.shape != (Bsz, S, N) or Cc.shape != Bc.shape
            or dt.shape != (Bsz, S, H) or A.shape != (H,)):
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(x.shape)}, "
                         f"B {tuple(Bc.shape)}, C {tuple(Cc.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}")
    if Q > MAX_CHUNK or N > MAX_STATE:
        raise ValueError(f"ssd_scan: chunk {Q} / state {N} above the "
                         f"kernel's {MAX_CHUNK} / {MAX_STATE}")
    if h0 is not None and (h0.dtype != torch.float32
                           or h0.shape != (Bsz, H, P, N)):
        raise ValueError(f"ssd_scan: h0 {h0.dtype} {tuple(h0.shape)}; "
                         f"need float32 {(Bsz, H, P, N)}")
    if not all(t.is_contiguous() for t in (x, Bc, Cc, dt, A)
               + (() if h0 is None else (h0,))):
        raise ValueError("ssd_scan: inputs must be contiguous")
    if x.numel() == 0 or N == 0:
        raise ValueError("ssd_scan: empty input")


def ssd_scan(x, Bc, Cc, dt, A, *, chunk: int = 64, h0=None):
    """x [B,S,H,P]; Bc,Cc [B,S,N]; dt [B,S,H] (fp32 post-softplus);
    A [H] negative; ``h0`` None (the scan starts from zero) or the
    carried state [B,H,P,N] fp32.  S must be a multiple of
    ``min(chunk, S)``.  Returns (y [B,S,H,P] fp32, h [B,H,P,N] fp32); an
    ``h0`` of zeros gives bitwise what ``h0=None`` gives.  The bf16 route also
    allocates its scratch: the chunks' states [B, S/Q, H, P, N] and their
    cum and dt [B, S/Q, H, 2, Q], fp32."""
    S = x.shape[1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of the chunk "
                         f"{Q}: pad the sequence first")
    if roofline.ACTIVE is not None:
        Bsz, _, H, P = x.shape
        return roofline.kernel(
            "ssd_scan", lambda: _ssd_scan(x, Bc, Cc, dt, A, chunk, h0),
            B=Bsz, S=S, H=H, P=P, N=Bc.shape[-1], Q=Q,
            itemsize=x.element_size(), h0=h0 is not None)
    return _ssd_scan(x, Bc, Cc, dt, A, chunk, h0)


def _ssd_scan(x, Bc, Cc, dt, A, chunk, h0):
    ins = (x, Bc, Cc, dt, A) + (() if h0 is None else (h0,))
    if all(t.device.type == "cpu" for t in ins):
        return ssd_chunked_ref(x, Bc, Cc, dt, A, chunk, h0)
    Bsz, S, H, P = x.shape
    N = Bc.shape[-1]
    if all(t.device.type == "meta" for t in ins):
        return (torch.empty(x.shape, dtype=torch.float32, device=x.device),
                torch.empty((Bsz, H, P, N), dtype=torch.float32,
                            device=x.device))
    Q = min(chunk, S)
    _check(x, Bc, Cc, dt, A, Q, h0)
    route = ssd_scan_route(x.dtype)
    lib = build.load_library()
    tc = route == TENSOR_CORES
    launch = lib.ssd_scan_bf16_launch if tc else lib.ssd_scan_f32_launch
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty(x.shape, **f32)
    h = torch.empty((Bsz, H, P, N), **f32)
    # the bf16 route's scratch: each chunk's state contribution, then the
    # state it starts from; each chunk's cum and dt
    scratch = [torch.empty((Bsz, S // Q, H, P, N), **f32),
               torch.empty((Bsz, S // Q, H, 2, Q), **f32)] if tc else []
    err = launch(*(t.data_ptr() for t in (x, Bc, Cc, dt, A)),
                 None if h0 is None else h0.data_ptr(),
                 *(t.data_ptr() for t in (y, h, *scratch)),
                 Bsz, S, H, P, N, Q,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, f"ssd_scan ({route})")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0


class SSDScan(torch.autograd.Function):
    """Kernel forward (padded to the chunk), plain-version backward."""

    @staticmethod
    def forward(ctx, x, Bc, Cc, dt, A, h0, chunk):
        ctx.save_for_backward(x, Bc, Cc, dt, A, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        xp, Bp, Cp, dtp, S = _pad_to_chunk(x.contiguous(), Bc.contiguous(),
                                           Cc.contiguous(),
                                           dt.contiguous(), chunk)
        y, h = ssd_scan(xp, Bp, Cp, dtp, A.contiguous(), chunk=chunk,
                        h0=None if h0 is None else h0.contiguous())
        return y[:, :S], h

    @staticmethod
    def backward(ctx, dy, dh):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [None if a is None else a.detach().requires_grad_(need)
                   for a, need in zip(saved, ctx.needs_input_grad[:6])]
            y, h = ssd_chunked_ref(*ins[:5], ctx.chunk, ins[5])
            outs = [o for o, g in ((y, dy), (h, dh)) if g is not None]
            seeds = [g for g in (dy, dh) if g is not None]
            needs = [a is not None and a.requires_grad for a in ins]
            wrt = [a for a, need in zip(ins, needs) if need]
            grads = iter(torch.autograd.grad(outs, wrt, seeds,
                                             allow_unused=True))
        return tuple(next(grads) if need else None
                     for need in needs) + (None,)


def ssd(x, Bc, Cc, dt, A, *, chunk: int = 64, h0=None):
    """x [B,S,H,P]; Bc,Cc [B,S,N]; dt [B,S,H]; A [H]; ``h0`` None or the
    carried fp32 state [B,H,P,N].  Returns (y [B,S,H,P] fp32, h_final
    [B,H,P,N] fp32), differentiable in every input."""
    return SSDScan.apply(x, Bc, Cc, dt, A, h0, int(chunk))
