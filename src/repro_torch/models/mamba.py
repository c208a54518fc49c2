"""Mamba-2 block via SSD (state-space duality), chunked form (port of
``repro/models/mamba.py``).

Recurrence (per head h, state N, head_dim P):
    h_t = exp(a_t) h_{t-1} + dt_t * B_t (x) x_t        a_t = dt_t * A
    y_t = C_t . h_t + D * x_t
Chunked evaluation: the intra-chunk quadratic term (the "dual",
attention-like form) plus the inter-chunk state carried over the chunks.
The chunk scan itself lives in :mod:`repro_torch.kernels.ssd_scan`
(``ssd_chunked_ref``, the plain version, and the CUDA kernel, which a
fused backend runs for scans that start from a zero state).

Parameters are stacked ``[n, ...]`` as every layer tree of the port.  With
a cache the block writes its new conv tails and state into the cache's
tensors **in place** (the reference returns an updated copy), as the
port's attention writes its K/V.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan.ops import ssd_chunked_ref
from repro_torch.models import layers as L
from repro_torch.models.sharding import copy_to_tp, reduce_from_tp, tp_env


def init_mamba(gen, n: int, d: int, cfg: SSMConfig, dtype,
               device) -> Dict[str, torch.Tensor]:
    """``n`` Mamba-2 blocks, leaves stacked ``[n, ...]``, at the
    reference's ``dense_init`` scales (not its bits: every weight has its
    own draw here, where the reference draws ``wo`` from ``wz``'s key).
    ``A_log``, ``D`` and ``dt_bias`` are fp32 at any parameter dtype."""
    d_in = cfg.expand * d
    H = d_in // cfg.head_dim
    N, W = cfg.state_dim, cfg.conv_width
    f32 = torch.float32

    def w(shape, fan_in):
        return L.dense_init(gen, (n,) + shape, fan_in, dtype, device)

    def full(shape, value, dt):
        return torch.full((n,) + shape, value, dtype=dt, device=device)

    return {
        "wz": w((d, d_in), d), "wx": w((d, d_in), d), "wB": w((d, N), d),
        "wC": w((d, N), d), "wdt": w((d, H), d),
        "conv_x": w((W, d_in), W), "conv_B": w((W, N), W),
        "conv_C": w((W, N), W),
        "A_log": full((H,), 0.0, f32), "D": full((H,), 1.0, f32),
        "dt_bias": full((H,), -2.0, f32),
        "norm_scale": full((d_in,), 1.0, dtype),
        "wo": w((d_in, d), d_in),
    }


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv. x [B,S,C]; w [W,C]; cache [B,W-1,C] or None."""
    W, S = w.shape[0], x.shape[1]
    if cache is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i]
    return out


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches
    to the identity above 20 and rounds differently below)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_block(params, x, cfg: SSMConfig, *, cache: Optional[dict] = None,
                norm_eps: float = 1e-6,
                backend=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B,S,d] -> (y [B,S,d], cache).

    ``cache`` {conv_x, conv_B, conv_C, h} or None: with a cache, S == 1 is
    a decode step and S > 1 a prefill chunk that starts from the cached
    conv tails and state; the cache is updated in place and returned.
    ``backend``: compute backend (:mod:`repro_torch.models.backend`); a
    fused one routes the chunk scan through the SSD kernel (train path,
    no carried state) and the gated norm through the RMSNorm kernel.
    None runs the plain versions.

    Under a tensor-parallel env (training, no cache) the leaves split
    over tp hold a rank's ``d_in / tp`` channels and ``H / tp`` heads
    (the reference's ``mamba_specs``): ``z``, ``x`` and ``dt`` are the
    rank's, the scan runs on its heads, the gated norm's rows span the
    ranks (the split-width norm: the sums of squares summed over tp) and
    ``wo``'s partial products are summed over tp."""
    B, S, d = x.shape
    d_full = cfg.expand * d
    P, W = cfg.head_dim, cfg.conv_width
    # the heads the leaves hold: all of them, or a tp rank's block where
    # a tensor-parallel env splits them
    H_full = d_full // P
    env = tp_env()
    if env is not None and not env.splits(H_full):
        env = None
    H = H_full if env is None else H_full // env.tp
    if params["wdt"].shape[-1] != H or (env is not None
                                         and cache is not None):
        raise ValueError(f"mamba_block: the leaves hold "
                         f"{params['wdt'].shape[-1]} of {H_full} heads, "
                         f"{H} expected"
                         + ("" if env is None else
                            f" (a training tp {env.tp} split, no cache)"))
    d_in = H * P
    # the split products read x through copy_to_tp (their input gradients
    # are partial over tp); B and C's products are replicated
    xs = x if env is None else copy_to_tp(x, env)

    z = xs @ params["wz"]
    xr = xs @ params["wx"]
    Bc = x @ params["wB"]
    Cc = x @ params["wC"]
    dt_raw = xs @ params["wdt"]

    decode = cache is not None and S == 1
    if decode:
        conv_in = {k: torch.cat([cache[k].to(t.dtype), t], dim=1)
                   for k, t in (("conv_x", xr), ("conv_B", Bc),
                                ("conv_C", Cc))}
        xr_c, Bc_c, Cc_c = ((conv_in[k][:, -W:] * params[k]).sum(
            dim=1, keepdim=True) for k in ("conv_x", "conv_B", "conv_C"))
        new_conv = {k: t[:, -(W - 1):] for k, t in conv_in.items()}
    else:
        # prefill: seed the conv window from the cached tail so chunked
        # prefill matches the full-sequence pass; a fresh zero cache is
        # bitwise the zero left-padding
        def c_of(k):
            return cache[k] if cache is not None else None
        xr_c = _causal_conv(xr, params["conv_x"], c_of("conv_x"))
        Bc_c = _causal_conv(Bc, params["conv_B"], c_of("conv_B"))
        Cc_c = _causal_conv(Cc, params["conv_C"], c_of("conv_C"))
        new_conv = None
        if cache is not None:    # carry the conv tail across chunks
            new_conv = {k: torch.cat([cache[k].to(t.dtype), t],
                                     dim=1)[:, -(W - 1):]
                        for k, t in (("conv_x", xr), ("conv_B", Bc),
                                     ("conv_C", Cc))}

    xr_c = F.silu(xr_c)
    Bc_c = F.silu(Bc_c)
    Cc_c = F.silu(Cc_c)
    if env is not None:
        # replicated B and C feed only this rank's heads: their gradients
        # are partial over tp and are summed on the way back, so that the
        # replicated wB, wC, conv_B and conv_C get whole, equal gradients
        Bc_c, Cc_c = copy_to_tp(Bc_c, env), copy_to_tp(Cc_c, env)

    A = -torch.exp(params["A_log"])                      # [H], negative
    dt = _softplus(dt_raw.float() + params["dt_bias"])

    xh = xr_c.reshape(B, S, H, P)

    if decode:
        h = cache["h"]
        a = torch.exp(dt[:, 0] * A)                      # [B,H]
        add = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0],
                           Bc_c[:, 0].float(), xh[:, 0].float())
        h_final = a[:, :, None, None] * h + add
        y = torch.einsum("bn,bhpn->bhp", Cc_c[:, 0].float(),
                         h_final)[:, None]               # [B,1,H,P]
    else:
        h0 = cache["h"] if cache is not None else None
        if backend is not None:
            y, h_final = backend.ssd(xh, Bc_c, Cc_c, dt, A,
                                     chunk=cfg.chunk_len, h0=h0)
        else:
            y, h_final = ssd_chunked_ref(xh, Bc_c, Cc_c, dt, A,
                                         cfg.chunk_len, h0)

    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in).to(x.dtype)
    gated, scale = y * F.silu(z), {"scale": params["norm_scale"]}
    if env is None:
        nrm = L.rmsnorm if backend is None else backend.rmsnorm
        y = nrm(scale, gated, norm_eps)
    else:
        # the gated norm's row spans the tp ranks' channels
        nrm = L.rmsnorm_split if backend is None else backend.rmsnorm_split
        y = nrm(scale, gated, norm_eps, d_full, env)
    out = y @ params["wo"]
    if env is not None:
        out = reduce_from_tp(out, env)

    if cache is not None:
        for k, t in new_conv.items():
            cache[k].copy_(t)
        cache["h"].copy_(h_final)
    return out, cache


def mamba_specs() -> Dict:
    """Logical sharding specs of :func:`init_mamba`'s leaves (the
    reference's)."""
    fsdp, tp = L.A_FSDP, L.A_TP
    return {"wz": (fsdp, tp), "wx": (fsdp, tp), "wB": (fsdp, None),
            "wC": (fsdp, None), "wdt": (fsdp, tp), "conv_x": (None, tp),
            "conv_B": (None, None), "conv_C": (None, None),
            "A_log": (tp,), "D": (tp,), "dt_bias": (tp,),
            "norm_scale": (tp,), "wo": (tp, fsdp)}


def init_mamba_cache(batch: int, d: int, cfg: SSMConfig, dtype,
                     device) -> Dict[str, torch.Tensor]:
    d_in = cfg.expand * d
    H = d_in // cfg.head_dim
    W = cfg.conv_width

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    return {
        "conv_x": zeros((batch, W - 1, d_in)),
        "conv_B": zeros((batch, W - 1, cfg.state_dim)),
        "conv_C": zeros((batch, W - 1, cfg.state_dim)),
        "h": zeros((batch, H, cfg.head_dim, cfg.state_dim), torch.float32),
    }
