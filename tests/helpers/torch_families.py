"""Rank bodies for ``tests/test_torch_mesh_families.py`` and
``tests/test_torch_mesh_encdec_vlm.py``: what each spawned gloo rank runs
(``repro_torch.launch.mesh.spawn`` pickles these by name) for the
Mamba-2, MoE and hybrid families, the encoder-decoder and the VLM on a
``pp x dp x tp`` mesh.  Imports torch and the port only, so a rank
starts without JAX.

The pipeline cases are ``tests/helpers/torch_mesh.py``'s (chronos_zb P=2
v=2 m=4, two sequences of 17 tokens a dp rank a microbatch); the
``train()`` runs ``tests/helpers/torch_zero.py``'s (one 32-token sequence
a dp rank a microbatch, chronos recompute over 2 chunks)."""
import dataclasses

import numpy as np
import torch

from helpers import torch_mesh as H
from helpers import torch_zero as Z
from repro_torch.bridge import lm_params_from_numpy, rank_params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.core import pipeline_runtime as PR
from repro_torch.kernels.rmsnorm import RMSNormSplit
from repro_torch.launch.steps import lm_shard, make_train_step
from repro_torch.launch.train import replica_checks, train, train_rank
from repro_torch.models import moe as MOE
from repro_torch.models.sharding import shard_env, tp_all_reduce, tp_env
from repro_torch.tree import tree_leaves, tree_unflatten


def reduced(arch, capacity_factor=None):
    """The reduced config of ``arch``, its MoE capacity factor replaced
    where one is given."""
    cfg = get_reduced(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def bridge_cuts(mesh, c, zero_stage):
    """Does the bridge's cut of the case's numpy tree for this rank
    (``rank_params_from_numpy(shard=)``) equal the shard's cut of the
    whole tree, leaf for leaf?"""
    spec = H.spec_of(c)
    shard = Z.rank_shard(spec, mesh.shape, mesh.coords, zero_stage)
    p = mesh.coord("pp")
    bridged = rank_params_from_numpy(c["params"], p, "cpu", shard=shard)
    cut = PR.rank_params(lm_params_from_numpy(c["params"], "cpu"), p, shard)
    return all(torch.equal(a, b) for a, b in zip(tree_leaves(bridged),
                                                 tree_leaves(cut)))


def split_norm(mesh, x, scale, dy, eps):
    """The split-width RMSNorm on this rank's tp half of the rows
    (``x`` [R, d], ``scale`` [d], the output's gradient ``dy``, all whole
    numpy): its output half and the gradients of its x and scale halves
    (the plain passes of the kernel pair, the all-reduces over tp), and
    its tp coordinate."""
    t, tp = mesh.coord("model"), mesh.tp
    w = x.shape[1] // tp
    cols = slice(t * w, (t + 1) * w)
    xs = torch.from_numpy(x[:, cols].copy()).requires_grad_()
    ss = torch.from_numpy(scale[cols].copy()).requires_grad_()
    with shard_env(mesh, mesh.rules):
        y = RMSNormSplit.apply(xs, ss, eps, x.shape[1],
                               tp_all_reduce(tp_env()))
    y.backward(torch.from_numpy(dy[:, cols].copy()))
    return {"y": y.detach(), "dx": xs.grad, "dscale": ss.grad, "tp": t}


def moe_layer(mesh, layer, x, dy, cfg, lb_weight):
    """One MoE layer (``layer``: its whole numpy leaves) on the rank's
    rows of the global ``x`` [B, S, d] (dp rank ``r`` the ``r``-th block of
    rows) and its tp shard of the experts (of the shared experts where tp
    divides their width, else the whole): the output rows, the aux
    values, and the gradients of ``sum(y * dy) + lb_weight * lb_loss``
    w.r.t. the rank's x rows and leaves."""
    d_, t = mesh.coord("data"), mesh.coord("model")
    rows = x.shape[0] // mesh.dp

    def cut(a, dim):
        n = a.shape[dim] // mesh.tp if a.shape[dim] % mesh.tp == 0 \
            else a.shape[dim]
        idx = [slice(None)] * a.ndim
        idx[dim] = slice(t * n, (t + 1) * n) if n != a.shape[dim] \
            else slice(None)
        return torch.from_numpy(a[tuple(idx)].copy()).requires_grad_()
    p = {"router": torch.from_numpy(layer["router"].copy()).requires_grad_(),
         "wi": cut(layer["wi"], 2), "wg": cut(layer["wg"], 2),
         "wo": cut(layer["wo"], 1),
         "shared": {"wi": cut(layer["shared"]["wi"], 1),
                    "wg": cut(layer["shared"]["wg"], 1),
                    "wo": cut(layer["shared"]["wo"], 0)}}
    xr = torch.from_numpy(x[d_ * rows:(d_ + 1) * rows].copy()).requires_grad_()
    with shard_env(mesh, mesh.rules):
        y, aux = MOE.moe_ffn(p, xr, cfg.moe, cfg.act)
        loss = (y * torch.from_numpy(dy[d_ * rows:(d_ + 1) * rows])).sum() \
            + lb_weight * aux["lb_loss"]
        loss.backward()
    return {"y": y.detach(), "lb_loss": float(aux["lb_loss"].detach()),
            "dropped": float(aux["router_fraction_dropped"]),
            "dx": xr.grad, "g": {"router": p["router"].grad,
                                 "wi": p["wi"].grad, "wg": p["wg"].grad,
                                 "wo": p["wo"].grad,
                                 "shared": {k: v.grad for k, v in
                                            p["shared"].items()}},
            "coords": dict(mesh.coords)}


def families_suite(mesh, cases, norm, moe):
    """On one rank of (2, 2, 2): each ``(case, zero_stage)`` of ``cases``
    through ``torch_zero.pipeline_grads`` (with the bridge's cut checked
    where the case carries numpy weights), the split-width norm
    (``norm``: the keywords of :func:`split_norm`) and the MoE layers
    (``moe``: a list of the keywords of :func:`moe_layer`)."""
    torch.set_num_threads(1)
    grads = []
    for c, z in cases:
        out = Z.pipeline_grads(mesh, c, z)
        out["bridge_equal"] = c["params"] is None or bridge_cuts(mesh, c, z)
        grads.append(out)
    return {"grads": grads, "norm": split_norm(mesh, **norm),
            "moe": [moe_layer(mesh, **m) for m in moe]}


def train_config(arch, capacity_factor=None, zero_stage=1):
    """``torch_zero.train_config`` of reduced ``arch`` (its MoE capacity
    factor replaced where one is given)."""
    tc = Z.train_config(zero_stage)
    return dataclasses.replace(tc, model=reduced(arch, capacity_factor))


def train_suite(mesh, runs):
    """On one rank of (1, dp, tp): ``train()`` for 3 steps of each
    ``(arch, capacity_factor, np_params)`` of ``runs`` from the bridged
    weights (the whole ``LM`` tree): the losses, the bytes handed to
    collectives each step by axis, the replica checks, the rank's final
    optimizer state, its shard's specs and cut dimensions."""
    torch.set_num_threads(1)
    out = []
    for arch, cf, np_params in runs:
        tc = train_config(arch, cf)
        shard = lm_shard(tc.model, mesh.shape, mesh.rules, mesh.coords, 1)
        checks = []
        res = train(tc, mesh=mesh, params=lm_params_from_numpy(np_params,
                                                               "cpu"),
                    steps=3, after_step=lambda _, p, o, s: checks.append(
                        replica_checks(mesh, p, o, s)), log=H.quiet)
        out.append({"losses": res["losses"],
                    "axis_bytes": res["exchange"]["axis_bytes"],
                    "replica_checks": checks, "coords": res["coords"],
                    "mu": res["opt_state"]["mu"],
                    "master": res["opt_state"]["master"],
                    "param_specs": shard.param_specs,
                    "cut_specs": shard.cut_specs,
                    "tp_parts": shard.tp_parts,
                    "zero_dims": shard.zero_dims})
    return out


def keep_mask(probs, K, cap):
    """The reference's keep mask (numpy): the ``[T * K]`` picks in the
    stable sort by expert of the flat (token, pick) order, each kept
    while its rank within its expert is below ``cap``; returned in the
    flat order.  ``probs`` [T, E]."""
    idx = np.argsort(-probs, axis=1, kind="stable")[:, :K].reshape(-1)
    order = np.argsort(idx, kind="stable")
    rank = np.empty_like(order)
    seen = {}
    for pos in order:
        e = idx[pos]
        rank[pos] = seen.get(e, 0)
        seen[e] = rank[pos] + 1
    return rank < cap


def encdec_vlm_suite(mesh, cases, runs, single=None):
    """On one rank: each ``(case, zero_stage)`` of ``cases`` through
    ``torch_zero.pipeline_grads`` (the bridge's cut checked), each ``(tc,
    P, kw)`` of ``runs`` through ``train_rank``; with ``single`` (``(shape,
    grads, trains)``) the processes regrouped as ``shape`` (pp 1), then
    each ``(cfg, zero_stage, np_params, batch)`` of ``grads`` through
    :func:`train_grads` and each ``(tc, np_params)`` of ``trains``
    through :func:`train_steps`."""
    torch.set_num_threads(1)
    out = {"grads": [], "train": [train_rank(mesh, tc, P, kw)
                                  for tc, P, kw in runs]}
    for c, z in cases:
        g = Z.pipeline_grads(mesh, c, z)
        g["bridge_equal"] = bridge_cuts(mesh, c, z)
        out["grads"].append(g)
    if single is not None:
        shape, grads, trains = single
        one = mesh.regroup(shape)
        out["single_grads"] = [train_grads(one, *a) for a in grads]
        out["single_train"] = [train_steps(one, *a) for a in trains]
    return out


def train_grads(mesh, cfg, zero_stage, np_params, batch):
    """On one rank of (1, dp, tp): the gradient part of ``train()``'s
    step (``step.grads``) for ``cfg`` at ``zero_stage`` from the bridged
    ``LM`` weights ``np_params`` on the global numpy ``batch`` (``[m,
    mbB * dp, ...]``): the rank's fp32 sums (its state slices, as a tree
    ``g``), the loss sum, the bytes handed to collectives by axis, and
    its shard's cut."""
    tc = dataclasses.replace(Z.train_config(zero_stage), model=cfg)
    m = batch["tokens"].shape[0]
    step, _ = make_train_step(cfg, tc.plan, tc.optimizer, m, device="cpu",
                              mesh=mesh)
    sh = step.shard
    params = sh.cut(lm_params_from_numpy(np_params, "cpu"))
    before = mesh.collective_bytes()
    gsum, lsum = step.grads(params, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    after = mesh.collective_bytes()
    return {"g": tree_unflatten(params, gsum), "lsum": float(lsum),
            "coords": dict(mesh.coords),
            "bytes": {a: after[a] - before[a] for a in after},
            "param_specs": sh.param_specs, "cut_specs": sh.cut_specs,
            "tp_parts": sh.tp_parts, "zero_dims": sh.zero_dims,
            "kv": sh.kv}


def train_steps(mesh, tc, np_params, steps=1):
    """On one rank of (1, dp, tp): ``steps`` steps of ``train(tc,
    mesh=)`` from the bridged ``LM`` weights (the synthetic source's
    batches, patch or frame embeddings too): the losses, the bytes
    handed to collectives each step by axis, and the replica checks after
    each step (the K/V groups' among them)."""
    checks = []
    res = train(tc, mesh=mesh, params=lm_params_from_numpy(np_params, "cpu"),
                steps=steps, after_step=lambda _, p, o, s: checks.append(
                    replica_checks(mesh, p, o, s)), log=H.quiet)
    return {"losses": res["losses"], "coords": res["coords"],
            "axis_bytes": res["exchange"]["axis_bytes"],
            "replica_checks": checks}
