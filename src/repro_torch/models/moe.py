"""Mixture-of-Experts FFN with top-k routing and capacity-based
sort/scatter dispatch (port of ``repro/models/moe.py``).

The router runs in fp32: softmax, top-k, gates renormalised over the k
picks.  Tokens are dispatched by a stable sort on their expert id into
``[E, cap, d]`` buffers (each token's rank within its expert decides
whether it fits; the rest go to a drop slot), the experts' products are
batched matmuls over that buffer, and the outputs come back gate-weighted
to their tokens.  A layer with shared experts adds their MLP.

Ties in the top-k break as ``lax.top_k`` breaks them, the lower expert
first: the picks are a stable descending sort of the probabilities.  The
combine is a gather, not the reference's scatter-add: each token sums its
``k`` outputs in the order of their sorted positions (ascending expert),
the order in which a sequential scatter-add adds them, so the forward is
deterministic on the card (CUDA's ``index_add`` adds by atomics in no
fixed order).  The backward's scatter of the dispatch gather still adds
a token's ``k`` input gradients by atomics on CUDA.  Nothing here syncs
with the host: the counts are an integer scatter-add, not
``bincount``.

Parameters are stacked ``[n, ...]`` as every layer tree of the port; the
functions below take one layer's (unstacked) tree.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding import (copy_to_tp, dp_env, reduce_from_tp,
                                         tp_env)


def init_moe(gen, n: int, d: int, cfg: MoEConfig, act: str, dtype,
             device) -> Dict:
    """``n`` MoE FFNs, leaves stacked ``[n, ...]``, at the reference's
    ``dense_init`` scales (not its bits): the router ``[d, E]`` in fp32
    at any parameter dtype, experts ``wi``/``wg`` ``[E, d, F]`` and
    ``wo`` ``[E, F, d]``, and the shared experts' MLP at
    ``num_shared_experts * d_ff_shared``."""
    E, F = cfg.num_experts, cfg.d_ff_expert
    p = {"router": L.dense_init(gen, (n, d, E), d, torch.float32, device),
         "wi": L.dense_init(gen, (n, E, d, F), d, dtype, device),
         "wo": L.dense_init(gen, (n, E, F, d), F, dtype, device)}
    if act in ("silu", "geglu"):
        p["wg"] = L.dense_init(gen, (n, E, d, F), d, dtype, device)
    if cfg.num_shared_experts:
        p["shared"] = L.init_mlp(gen, n, d,
                                 cfg.num_shared_experts * cfg.d_ff_shared,
                                 act, dtype, device)
    return p


A_EXP = "exp"


def moe_specs(cfg: MoEConfig, act: str) -> Dict:
    """Logical sharding specs of :func:`init_moe`'s leaves (the
    reference's): the experts over "exp" and their hidden width over
    tp; the router replicated."""
    specs = {"router": (None, None),
             "wi": (A_EXP, L.A_FSDP, L.A_TP),
             "wo": (A_EXP, L.A_TP, L.A_FSDP)}
    if act in ("silu", "geglu"):
        specs["wg"] = (A_EXP, L.A_FSDP, L.A_TP)
    if cfg.num_shared_experts:
        specs["shared"] = L.mlp_specs(act)
    return specs


def capacity(T: int, cfg: MoEConfig) -> int:
    """Slots per expert for ``T`` tokens: ``ceil(T k / E)`` times the
    capacity factor, rounded up to a multiple of 128 (or of 16 below
    128), as the reference rounds it."""
    K, E = cfg.top_k, cfg.num_experts
    cap = int(max(1, -(-T * K // E) * cfg.capacity_factor))
    quantum = 128 if cap >= 128 else 16
    return -(-cap // quantum) * quantum


def route(xt, router, K: int):
    """fp32 router: ``(probs [T, E], gate_vals [T, K], gate_idx [T, K])``
    with the gates renormalised over the picks; ties pick the lower
    expert first (``lax.top_k``'s order)."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    _, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_idx = order[:, :K]
    gate_vals = probs.gather(1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def moe_ffn(params, x, cfg: MoEConfig, act: str) -> Tuple[torch.Tensor,
                                                          Dict]:
    """x: [B, S, d] -> (y, aux) with aux = {"lb_loss",
    "router_fraction_dropped"} (fp32 scalars).

    Under a data-parallel env ``x`` is the rank's rows of the global
    microbatch (dp rank ``r`` holds its ``r``-th block of rows) and the
    routing is the reference's over the global microbatch: the ranks'
    ``[E]`` expert counts are all-gathered over dp, the capacity is
    reckoned from the global token count, and a token's rank within its
    expert is the counts of the dp ranks before it plus its rank here
    (the stable sort of the global token order), so the kept tokens and
    ``router_fraction_dropped`` are the global ones.  ``lb_loss`` is
    then this rank's share of the global loss, ``E * sum(p_r / T *
    ce)`` with ``p_r`` the rank's summed probabilities, ``T`` the global
    token count and ``ce`` the global expert fractions: the ranks' shares
    sum to the global ``lb_loss`` (as their cross-entropy parts sum to
    the global mean), and each share's gradient reaches only the rank's
    own tokens.  The rank's expert products run on a ``[E, cap, d]``
    buffer of its own kept tokens (``cap`` the global capacity).

    Under a tensor-parallel env that splits the experts' hidden width
    ``wi`` / ``wg`` / ``wo`` hold the rank's ``F / tp`` of each expert
    (and the shared experts theirs): the router stays replicated in
    fp32, so every tp rank routes alike; the tokens enter the experts
    through ``copy_to_tp``, the gates that weight the partial outputs
    too, and the combined partial outputs (with the shared experts') are
    summed over tp once."""
    Bz, S, d = x.shape
    T = Bz * S
    E, K = cfg.num_experts, cfg.top_k
    xt = x.reshape(T, d)
    dev = x.device
    tp, dpe = tp_env(), dp_env()
    split = tp is not None and tp.splits(cfg.d_ff_expert)

    probs, gate_vals, gate_idx = route(xt, params["router"], K)

    # ---- load-balancing auxiliary loss (Switch-style) ----
    flat_exp = gate_idx.reshape(-1)                           # [T*K]
    counts = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(
        0, flat_exp, torch.ones_like(flat_exp))
    if dpe is None:
        T_all, before, counts_all = T, None, counts
        me = probs.mean(dim=0)                                # [E]
    else:
        ranks = [torch.empty_like(counts) for _ in range(dpe.dp)]
        dpe.mesh.all_gather_into(ranks, counts, dpe.dp_axis)
        r = dpe.mesh.coord(dpe.dp_axis)
        counts_all = torch.stack(ranks).sum(dim=0)
        before = sum(ranks[:r], torch.zeros_like(counts))
        T_all = T * dpe.dp
        me = probs.sum(dim=0) / T_all      # this rank's share of the mean
    ce = counts_all.float() / T_all  # mean over tokens of the k-hot rows
    lb_loss = E * (me * ce).sum()

    # ---- sort-based capacity dispatch ----
    cap = capacity(T_all, cfg)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
    flat_w = gate_vals.reshape(-1)
    order = torch.argsort(flat_exp, stable=True)
    sorted_exp = flat_exp[order]
    sorted_tok = flat_tok[order]
    sorted_w = flat_w[order]
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - offsets[sorted_exp]
    # the rank within the expert over the global microbatch
    keep = (rank if before is None else rank + before[sorted_exp]) < cap
    dest = torch.where(keep, sorted_exp * cap + rank,
                       torch.full_like(rank, E * cap))        # drop slot

    # scatter tokens into [E*cap (+1 drop slot), d]; only the drop slot
    # takes more than one row, and it is cut off
    xe = copy_to_tp(xt, tp) if split else xt
    src = xe[sorted_tok] * keep[:, None].to(x.dtype)
    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype,
                      device=dev).index_copy(0, dest, src)
    eb = buf[:E * cap].reshape(E, cap, d)

    h = torch.bmm(eb, params["wi"])
    if "wg" in params:
        h = L._act(torch.bmm(eb, params["wg"]), act) * h
    else:
        h = L._act(h, act)
    out = torch.bmm(h, params["wo"])                          # [E, cap, d]

    # gather back + weighted combine: token t's rows of ``back`` sit at
    # the sorted positions of its k picks, added in ascending position
    out_flat = torch.cat([out.reshape(E * cap, d),
                          torch.zeros((1, d), dtype=out.dtype, device=dev)])
    w = sorted_w * keep
    if split:
        w = copy_to_tp(w, tp)        # the gates weight partial outputs
    back = out_flat[dest] * w[:, None].to(out.dtype)
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=dev))
    pos = pos.view(T, K).sort(dim=1).values
    y = back[pos[:, 0]]
    for k in range(1, K):
        y = y + back[pos[:, k]]

    shared = None
    if "shared" in params:
        ff = cfg.num_shared_experts * cfg.d_ff_shared
        if split and tp.splits(ff):
            y = y + L.mlp_body(params["shared"], xe, act)
        else:       # whole on every rank, or split and summed on its own
            shared = L.mlp(params["shared"], xt, act, d_ff=ff)
    if split:
        y = reduce_from_tp(y, tp)
    if shared is not None:
        y = y + shared

    dropped = 1.0 - counts_all.clamp(max=cap).sum().float() / (T_all * K)
    aux = {"lb_loss": lb_loss, "router_fraction_dropped": dropped}
    return y.reshape(Bz, S, d), aux
