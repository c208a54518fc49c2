"""Core building blocks of the port (mirror of ``repro/models/layers.py``).

Conventions (same as the reference): activations [batch, seq, d_model];
attention heads [B, S, H, hd]; norms and softmax run in fp32 whatever the
compute dtype.  Weights keep the JAX layout — ``wq`` is ``[d, H*hd]`` and
is applied as ``x @ W`` — so bridged weights are leaf-for-leaf copies.

Each ``*_specs`` function gives its leaves' logical sharding specs, the
ones the reference's ``init_*`` returns.  Under a tensor-parallel env
(:func:`repro_torch.models.sharding.tp_env`) the layers run on their
leaves' tp shards, as GSPMD runs the reference's under those specs:
:func:`mlp` and :func:`attention` split their hidden width (heads) by
columns and their output projection by rows and sum the partial outputs
over tp; :func:`embed` looks up the rank's vocab rows; :func:`unembed`
and :func:`softmax_xent` give vocab-parallel logits and their
cross-entropy.  A leaf whose width tp does not divide stays whole
(``sanitize_spec`` drops the axis) and its layer runs unsplit.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import (copy_to_tp, max_over_tp,
                                         reduce_from_tp, sum_over_tp, tp_env)

NEG_INF = -2.0 ** 30
A_TP, A_FSDP = "tp", "fsdp"


def dense_init(gen, shape, fan_in: int, dtype, device):
    """``dense_init``: N(0, 1) / sqrt(fan_in), drawn in fp32 on the
    generator's device, then cast and moved to ``device``.  ``gen`` None
    builds the shape only, on the meta device (the dry run's), where no
    generator exists."""
    if gen is None:
        if torch.device(device).type != "meta":
            raise ValueError(f"dense_init: no generator for a tensor on "
                             f"{device}; only the meta device builds "
                             "shapes without one")
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, device=gen.device)
    # scaled in place: one fp32 draw alive at a time (a full-width MoE
    # expert stack is 4.2 G elements)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype).to(device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_specs():
    return {"scale": (None,)}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def rmsnorm_split(params, x, eps: float, d_full: int, env):
    """:func:`rmsnorm` of rows whose ``d_full`` columns are cut over the
    tp ranks of ``env`` (``x`` and ``params["scale"]`` hold this rank's):
    the rows' sums of squares summed over tp, differentiably
    (:func:`~repro_torch.models.sharding.sum_over_tp`)."""
    dt = x.dtype
    x32 = x.float()
    ss = sum_over_tp(x32.square().sum(dim=-1, keepdim=True), env)
    y = x32 * torch.rsqrt(ss / d_full + eps)
    return (y * params["scale"].float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [B, S, H, hd]; positions: [B, S] (int)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    ang = positions.float()[..., None] * freqs               # [B, S, hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (swiglu / geglu / gelu)
# ---------------------------------------------------------------------------

def init_mlp(gen, n: int, d: int, ff: int, act: str, dtype, device):
    """``n`` MLPs, leaves stacked ``[n, ...]``: ``wi`` [d, ff], ``wo``
    [ff, d], and the gate ``wg`` [d, ff] for the gated activations."""
    p = {"wi": dense_init(gen, (n, d, ff), d, dtype, device),
         "wo": dense_init(gen, (n, ff, d), ff, dtype, device)}
    if act in ("silu", "geglu"):
        p["wg"] = dense_init(gen, (n, d, ff), d, dtype, device)
    return p


def mlp_specs(act: str):
    specs = {"wi": (A_FSDP, A_TP), "wo": (A_TP, A_FSDP)}
    if act in ("silu", "geglu"):
        specs["wg"] = (A_FSDP, A_TP)
    return specs


def _act(x, act: str):
    if act in ("silu",):
        return F.silu(x)
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def mlp(params, x, act: str, d_ff: Optional[int] = None):
    """``d_ff``: the full hidden width, read only under a tp env: where
    tp divides it the leaves are the rank's columns of ``wi`` / ``wg``
    and rows of ``wo``, and the partial outputs are summed over tp."""
    env = tp_env()
    split = env is not None and d_ff is not None and env.splits(d_ff)
    if split:
        x = copy_to_tp(x, env)
    y = mlp_body(params, x, act)
    return reduce_from_tp(y, env) if split else y


def mlp_body(params, x, act: str):
    """The MLP's products on the leaves as they are (under tp a rank's
    partial output: the caller enters ``x`` through ``copy_to_tp`` and
    sums the output over tp)."""
    h = x @ params["wi"]
    if "wg" in params:
        h = _act(x @ params["wg"], act) * h
    else:
        h = _act(h, act)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_specs(tie: bool):
    specs = {"tokens": (A_TP, A_FSDP)}
    if not tie:
        specs["head"] = (A_FSDP, A_TP)
    return specs


def _vocab_split(vocab: Optional[int]):
    """The tp env when the vocab (of ``vocab`` rows) is split over it."""
    env = tp_env()
    return env if env is not None and vocab is not None \
        and env.splits(vocab) else None


def embed(params, tokens, vocab: Optional[int] = None):
    """tokens [B, S] -> [B, S, d].  Under a tp env that splits the
    ``vocab`` rows (the vocab-parallel lookup): the rank looks up the
    tokens in its rows, gives zeros for the others, and the lookups are
    summed over tp."""
    env = _vocab_split(vocab)
    if env is None:
        return params["tokens"][tokens]
    rows = params["tokens"].shape[0]
    local = tokens - env.mesh.coord(env.tp_axis) * rows
    inside = (local >= 0) & (local < rows)
    out = params["tokens"][local.clamp(0, rows - 1)]
    out = torch.where(inside[..., None], out, torch.zeros_like(out))
    return reduce_from_tp(out, env)


def unembed(params, x, vocab: Optional[int] = None):
    """Logits ``x @ head`` (or the tied ``tokens.T``); under a tp env that
    splits the ``vocab``, the rank's vocab columns of them."""
    env = _vocab_split(vocab)
    if env is not None:
        x = copy_to_tp(x, env)
    if "head" in params:
        return x @ params["head"]
    return x @ params["tokens"].T.to(x.dtype)


def softmax_xent(logits, labels, mask=None, denom=None,
                 vocab: Optional[int] = None):
    """Stable CE in fp32 (mirror of the reference's ``softmax_xent``; the
    gold logit is a gather here, which picks the same value as the
    reference's one-hot contraction).

    ``denom``: fixed normalizer replacing the local mean — sequence-
    chunked losses pass the *whole-sequence* token (or mask) count so
    per-chunk partial losses sum to the full-sequence loss."""
    lg = logits.float()
    env = _vocab_split(vocab)
    if env is None:
        m = lg.amax(dim=-1, keepdim=True)
        lse = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
        gold = lg.gather(-1, labels.long()[..., None])[..., 0]
    else:
        # vocab-parallel: ``logits`` are the rank's columns; the max, the
        # sum of exponentials and the gold logit are reduced over tp, so
        # every tp rank holds the whole loss
        m = max_over_tp(lg.amax(dim=-1, keepdim=True), env)
        lse = torch.log(reduce_from_tp(torch.exp(lg - m).sum(dim=-1), env)) \
            + m[..., 0]
        cols = lg.shape[-1]
        local = labels.long() - env.mesh.coord(env.tp_axis) * cols
        inside = (local >= 0) & (local < cols)
        g = lg.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
        gold = reduce_from_tp(torch.where(inside, g, torch.zeros_like(g)),
                              env)
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        if denom is None:
            return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    if denom is not None:
        return nll.sum() / denom
    return nll.mean()


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_specs(qkv_bias: bool = False):
    specs = {"wq": (A_FSDP, A_TP), "wk": (A_FSDP, A_TP),
             "wv": (A_FSDP, A_TP), "wo": (A_TP, A_FSDP)}
    if qkv_bias:
        for n in ("bq", "bk", "bv"):
            specs[n] = (A_TP,)
    return specs


def make_mask(q_pos, kv_pos, *, causal: bool, window=0,
              prefix_len: int = 0):
    """Boolean [.., Sq, Skv] mask. q_pos/kv_pos: [..,S] ints.
    ``window`` may be an int or a 0-d tensor (0 => full)."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    if causal:
        ok = kp <= qp
    else:
        ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                        dtype=torch.bool, device=qp.device)
    if prefix_len:
        ok = ok | (kp < prefix_len)
    if isinstance(window, int):
        if window:
            ok = ok & (qp - kp < window)
    else:  # per-layer flag carried as data
        ok = ok & ((window <= 0) | (qp - kp < window))
    return ok


def dense_attention(q, k, v, mask, scale):
    """q [B,S,H,hd]; k,v [B,T,G,hd]; mask broadcastable to [B,1,1,S,T]."""
    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    R = H // G
    qg = q.reshape(B, S, G, R, hd)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(), k.float()) * scale
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", probs.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def blockwise_attention(q, k, v, scale, *, causal: bool, window: int = 0,
                        prefix_len: int = 0, q_offset: int = 0,
                        block: int = 1024):
    """Flash-style O(S·block) attention for long sequences (the plain path
    past ``dense_threshold``; the flash kernel computes the same math).

    q [B,S,H,hd]; k,v [B,T,G,hd].  q position i is absolute position
    q_offset + i; kv positions are 0..T-1.  The reference scans over the
    kv blocks; here that scan is a Python loop."""
    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    R = H // G
    nblk = -(-T // block)
    Tpad = nblk * block
    if Tpad != T:
        k = F.pad(k, (0, 0, 0, 0, 0, Tpad - T))
        v = F.pad(v, (0, 0, 0, 0, 0, Tpad - T))
    qg = q.reshape(B, S, G, R, hd).float()
    q_pos = q_offset + torch.arange(S, device=q.device)
    m = torch.full((B, G, R, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, G, R, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, G, R, S, hd), dtype=torch.float32, device=q.device)
    for b in range(nblk):
        kblk = k[:, b * block:(b + 1) * block]
        vblk = v[:, b * block:(b + 1) * block]
        kv_pos = b * block + torch.arange(block, device=q.device)
        s = torch.einsum("bsgrd,btgd->bgrst", qg, kblk.float()) * scale
        msk = make_mask(q_pos, kv_pos, causal=causal, window=window,
                        prefix_len=prefix_len)
        msk = msk & (kv_pos < T)[None, :]
        s = s.masked_fill(~msk[None, None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bgrst,btgd->bgrsd", p, vblk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return out.to(q.dtype)


def attention(params, x, positions, *, num_heads: int, num_kv: int, hd: int,
              rope_theta: float, causal: bool = True, window=0,
              prefix_len: int = 0, cache: Optional[dict] = None,
              kv: Optional[dict] = None, cache_pos: int = 0,
              kv_x=None, kv_direct=None, use_rope: bool = True,
              return_kv: bool = False, dense_threshold: int = 8192,
              backend=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention: train (``cache=None``, ``kv=None``), sequence-
    chunked train over a KV buffer (``kv``), cache prefill and decode
    (``cache``); cross-attention: K/V projected from the encoder output
    ``kv_x`` [B, T, d], or read from precomputed heads ``kv_direct`` =
    (k, v) [B, T, G, hd] (the decode path over cached cross K/V).
    ``use_rope=False`` skips the rotary embedding (cross-attention);
    ``return_kv=True`` returns ``(y, (k, v))`` in place of ``(y,
    new_cache)`` (the cross K/V a prefill caches).

    Serving (``cache``): the step's K/V are written into ``cache`` **in
    place** at ``cache_pos`` (the reference returns an updated copy; the
    buffers here are the caller's slot caches, and writing them in place
    saves a copy of the whole buffer per layer per step) and the returned
    cache is the same dict.  Never under autograd: an in-place write into
    a buffer that needs a gradient breaks the dKV carry.

    Sequence-chunked training (``kv``, the full-sequence K/V buffer
    {"k", "v"} [B, S_full, G, hd] of the chunk's microbatch): the chunk's
    K/V enter the buffer through
    :func:`~repro_torch.seqpipe.attention.merge_kv`, out of place, and
    the returned dict is the merged buffer, so the cotangent of the
    prefix reaches ``kv``.  In both modes the query (absolute positions
    from ``cache_pos``) then attends over the whole buffer.

    A fused ``backend`` routes every self-attention of length S > 1 with
    a static window (train, sequence-chunked train and prefill at offset
    ``cache_pos``) through the flash kernel; decode (S == 1) takes the
    dense path by design.
    Without it, a kv longer than ``dense_threshold`` takes
    :func:`blockwise_attention` and a shorter one the dense path.
    Cross-attention (no mask: every query sees every encoder position)
    stays on the plain dense path, as the reference keeps it out of its
    kernel.

    Under a tp env the query and K/V head counts are read from the leaf
    widths: where ``wq`` holds fewer than ``num_heads`` heads it is the
    rank's block of query heads (``H / tp`` from ``t * H / tp``) and
    ``wk`` / ``wv`` its block of K/V heads (``G / tp`` from ``t * G /
    tp``: the groups of those query heads; where G divides tp, the one
    head ``t // (tp / G)`` of them, replicated over ``tp / G`` ranks),
    ``wo`` the matching rows, and the partial outputs are summed over
    tp.  Both replicated inputs of the split products enter through
    ``copy_to_tp``: ``x``, and a cross-attention's encoder output
    ``kv_x``, so each one's gradient is the whole one on every rank."""
    B, S, _ = x.shape
    scale = 1.0 / math.sqrt(hd)
    heads = params["wq"].shape[-1] // hd
    split = heads != num_heads
    env = tp_env() if split else None
    if split:
        if env is None or heads * env.tp != num_heads:
            raise ValueError(f"attention: wq holds {heads} of {num_heads} "
                             "heads outside a tensor-parallel env of that "
                             "split")
        num_kv = params["wk"].shape[-1] // hd
        num_heads = heads
        x = copy_to_tp(x, env)
        if kv_x is not None:
            kv_x = copy_to_tp(kv_x, env)
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    q = q.reshape(B, S, num_heads, hd)
    if kv_direct is not None:
        k, v = kv_direct
    else:
        src = x if kv_x is None else kv_x
        Skv = src.shape[1]
        k = src @ params["wk"]
        v = src @ params["wv"]
        if "bk" in params:
            k, v = k + params["bk"], v + params["bv"]
        k = k.reshape(B, Skv, num_kv, hd)
        v = v.reshape(B, Skv, num_kv, hd)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        if kv_x is None:
            k = apply_rope(k, positions, rope_theta)
        else:
            Skv = k.shape[1]
            k = apply_rope(k, torch.arange(Skv, device=x.device)[None]
                           .expand(B, Skv), rope_theta)
    cross = kv_x is not None or kv_direct is not None

    new_cache = None
    if cross:
        pass
    elif cache is not None:
        cache["k"][:, cache_pos:cache_pos + S] = k.to(cache["k"].dtype)
        cache["v"][:, cache_pos:cache_pos + S] = v.to(cache["v"].dtype)
        new_cache = cache
    elif kv is not None:
        from repro_torch.seqpipe.attention import merge_kv
        new_cache = merge_kv(kv, k, v, cache_pos)
    if new_cache is not None:
        k, v = new_cache["k"], new_cache["v"]
    q_offset = 0 if new_cache is None else cache_pos
    kv_len = k.shape[1]

    fuse = (backend is not None and backend.fuse_attention and not cross
            and isinstance(window, int) and S > 1
            and (new_cache is None or causal))
    if cross:
        out = dense_attention(q, k, v, torch.ones(
            (1, 1, 1, S, kv_len), dtype=torch.bool, device=x.device), scale)
    elif fuse:
        # self-attention over the whole kv (train: kv_len == S; chunked
        # train and prefill: the buffer at offset cache_pos — causal
        # masking hides everything past the frontier)
        out = backend.flash(q, k, v, causal=causal, window=window,
                            prefix=prefix_len, q_offset=q_offset)
    elif S == 1 and new_cache is not None:
        # decode: one query over the whole cache
        kv_pos = torch.arange(kv_len, device=x.device)
        q_pos = positions[:, -1:]                     # [B, 1]
        msk = make_mask(q_pos, kv_pos, causal=causal, window=window,
                        prefix_len=prefix_len)        # [B, 1, T]
        out = dense_attention(q, k, v, msk[:, None, None, :, :], scale)
    elif kv_len > dense_threshold:
        out = blockwise_attention(
            q, k, v, scale, causal=causal, window=window,
            prefix_len=prefix_len, q_offset=q_offset)
    else:
        kv_pos = torch.arange(kv_len, device=x.device)
        msk = make_mask(positions[0], kv_pos, causal=causal, window=window,
                        prefix_len=prefix_len)
        out = dense_attention(q, k, v, msk[None, None, None], scale)

    y = out.reshape(B, S, num_heads * hd) @ params["wo"]
    if split:
        y = reduce_from_tp(y, env)
    if return_kv:
        return y, (k, v)
    return y, new_cache
