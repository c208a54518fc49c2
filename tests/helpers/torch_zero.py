"""Rank bodies for ``tests/test_torch_zero.py``: what each spawned gloo
rank runs (``repro_torch.launch.mesh.spawn`` pickles these by name) and
the joins of the ranks' parts into global trees.  Imports torch and the
port only, so a rank starts without JAX.

The pipeline cases are ``tests/helpers/torch_mesh.py``'s (reduced
tinyllama, chronos_zb P=2 v=2 m=4, two sequences of 17 tokens a dp rank
a microbatch)."""
import weakref

import torch

from helpers import torch_mesh as H
from repro_torch.bridge import lm_params_from_numpy, rank_params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.configs.base import (OptimizerConfig, ParallelPlan,
                                      RecomputeConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core import pipeline_runtime as PR
from repro_torch.launch import mesh as M
from repro_torch.launch.steps import lm_shard
from repro_torch.launch.train import replica_checks, train
from repro_torch.models.sharding import join_shards
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# train(): the JAX pair's sizes (tests/test_torch_train_single.py's), a
# dp rank reading one of the two sequences of each microbatch
TRAIN_SEQ, GLOBAL_BATCH = 32, 4
OCFG = dict(warmup_steps=1, total_steps=3, lr=1e-3)
SEED = 5
PERIOD_ARCH = "gemma3-27b"      # reduced: one period of six layers


def rank_shard(spec, shape, coords, zero_stage):
    return PR.RankShard(spec.cfg, spec.layout, shape, M.MESH_RULES, coords,
                        zero_stage)


class _HeldWatch:
    """Between the ops of a rank's tick loop: how many gathered leaves
    are still alive (``Mesh.all_gather_cat``'s outputs, by weak
    reference), and the shapes and dtypes of the block accumulators."""

    def __init__(self):
        self.refs, self.live_max, self.ops = [], 0, 0
        self.acc = None

    def __enter__(self):
        self.cat, self.op = M.Mesh.all_gather_cat, PR._RankExecutor._op
        watch = self

        def cat(mesh, ts, axis, dims):
            out = watch.cat(mesh, ts, axis, dims)
            watch.refs.extend(weakref.ref(o) for o in out)
            return out

        def op(ex, d, row, params, shared, batch, acc):
            out = watch.op(ex, d, row, params, shared, batch, acc)
            watch.ops += 1
            watch.live_max = max(watch.live_max,
                                 sum(r() is not None for r in watch.refs))
            watch.acc = [(tuple(a.shape), str(a.dtype))
                         for a in tree_leaves(acc["gb"])]
            return out
        M.Mesh.all_gather_cat, PR._RankExecutor._op = cat, op
        return self

    def __exit__(self, *exc):
        M.Mesh.all_gather_cat, PR._RankExecutor._op = self.cat, self.op


def pipeline_grads(mesh, c, zero_stage, watch=False):
    """One rank's gradients of case ``c`` at ``zero_stage``, its loss,
    its coordinates, the bytes it handed to collectives by axis, the
    shapes of the parameters it held and, with ``watch``, what was held
    between its ops (:class:`_HeldWatch`)."""
    spec = H.spec_of(c)
    shard = rank_shard(spec, mesh.shape, mesh.coords, zero_stage)
    p = mesh.coord("pp")
    if c["params"] is not None:
        params = rank_params_from_numpy(c["params"], p, "cpu", shard=shard)
    else:
        params = PR.rank_params(H.full_params(c, spec), p, shard)
    fn = PR.make_train_grads_fn(spec, "cpu", mesh=mesh, shard=shard)
    before = mesh.collective_bytes()
    w = _HeldWatch() if watch else None
    if w is not None:
        with w:
            g, met = fn(params, H.batch_of(c))
    else:
        g, met = fn(params, H.batch_of(c))
    after = mesh.collective_bytes()
    sent = fn.exchange.stats()["bytes_sent"]
    out = {"g": g, "loss": met["loss"], "coords": dict(mesh.coords),
           "n": met["n_microbatches"],
           "param_shapes": [tuple(a.shape) for a in tree_leaves(params)],
           "bytes": {a: after[a] - before[a] + (sent if a == "pp" else 0)
                     for a in after}}
    if w is not None:
        out["held"] = {"live_max": w.live_max, "ops": w.ops,
                       "gathers": len(w.refs), "acc": w.acc}
    return out


def pipeline_suite(mesh, cases, runs):
    """On one rank of (2, 2, 2): each ``(case, zero_stage, watch)`` of
    ``cases`` through :func:`pipeline_grads`, then each ``(tc, P, kw)``
    of ``runs`` through ``train_rank``."""
    from repro_torch.launch.train import train_rank
    torch.set_num_threads(1)
    return {"grads": [pipeline_grads(mesh, c, z, w) for c, z, w in cases],
            "train": [train_rank(mesh, tc, P, kw) for tc, P, kw in runs]}


def join_pipeline(spec, shape, ranks, zero_stage):
    """The global gradient tree from every rank's part (``ranks``: one
    :func:`pipeline_grads` result a rank): each leaf joined over tp and,
    where the rank holds a dp slice, over dp; the block leaves stacked
    over pp, the shared ones from pp 0."""
    by = {(r["coords"]["pp"], r["coords"]["data"], r["coords"]["model"]): r
          for r in ranks}
    shard = rank_shard(spec, shape, {"pp": 0, "data": 0, "model": 0},
                       zero_stage)
    tp = shape["model"]
    leaves = []
    for i, (path, sp) in enumerate(zip(shard.paths, shard.cut_specs)):
        parts = shard.tp_parts[i]
        sizes = {"model": parts, "data": shape["data"]}

        def col(p):
            return join_shards(lambda co: tree_leaves(by[
                p, co.get("data", (0, 1))[0], H.tp_rank(co, tp, parts)]
                ["g"])[i], sp, sizes)
        if path[0] == "blocks":
            leaves.append(torch.stack([col(p) for p in range(shape["pp"])]))
        else:
            leaves.append(col(0))
    return tree_unflatten(PR.init_pipeline_params(None, spec.cfg,
                                                  spec.layout, "meta"),
                          leaves)


# ---------------------------------------------------------------------------
# train() on a 1 x dp x tp mesh
# ---------------------------------------------------------------------------

def train_config(zero_stage, arch="tinyllama-1.1b"):
    """Reduced ``arch`` through ``train()``: one sequence a dp rank a
    microbatch, chronos recompute over 2 chunks, at ``zero_stage``."""
    return TrainConfig(
        model=get_reduced(arch),
        shape=ShapeConfig("t", TRAIN_SEQ, GLOBAL_BATCH, "train"),
        plan=ParallelPlan(num_chunks=2, microbatch_size=1,
                          recompute=RecomputeConfig(mode="chronos"),
                          kernels="fused", zero_stage=zero_stage),
        optimizer=OptimizerConfig(**OCFG), seed=SEED, log_every=100)


def train_suite(mesh, np_params, stages):
    """On one rank of (1, dp, tp): ``train()`` from the bridged JAX
    weights (``np_params``, the whole ``LM`` tree) for 3 steps at each
    ZeRO stage of ``stages``; per stage the losses, gradient norms, the
    bytes handed to collectives each step by axis, the replica checks,
    the rank's final weights and optimizer state (on the CPU), and what
    the rank holds (its shard's specs and cut dimensions, the weights'
    shapes); and the bridge's cut (``lm_params_from_numpy(shard=)``)
    against the shard's cut of the whole tree.  Under ``"period"``, the
    bytes of one step of reduced gemma3-27b at stage 3, whose one
    checkpointed period holds six layers."""
    torch.set_num_threads(1)
    out = {}
    for z in stages:
        tc = train_config(z)
        shard = lm_shard(tc.model, mesh.shape, mesh.rules, mesh.coords, z)
        whole = lm_params_from_numpy(np_params, "cpu")
        bridged = lm_params_from_numpy(np_params, "cpu", shard=shard)
        checks = []
        res = train(tc, mesh=mesh, params=whole, steps=3,
                    after_step=lambda _, p, o, s: checks.append(
                        replica_checks(mesh, p, o, s)),
                    log=H.quiet)
        out[z] = {
            "losses": res["losses"], "grad_norms": res["grad_norms"],
            "axis_bytes": res["exchange"]["axis_bytes"],
            "replica_checks": checks, "coords": res["coords"],
            "params": res["params"],
            "mu": res["opt_state"]["mu"],
            "master": res["opt_state"]["master"],
            "param_specs": shard.param_specs, "cut_specs": shard.cut_specs,
            "tp_parts": shard.tp_parts,
            "zero_dims": shard.zero_dims, "fsdp_dims": shard.fsdp_dims,
            "bridge_equal": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(bridged), tree_leaves(shard.cut(whole))))}
    res = train(train_config(3, PERIOD_ARCH), mesh=mesh, steps=1,
                log=H.quiet)
    out["period"] = res["exchange"]["axis_bytes"]
    return out


def state_spec(param_spec, zero_dim):
    """The physical spec of a rank's optimizer-state leaf: its
    parameter's, with "data" where the state is cut over dp (after
    "model" on a tp-split dimension: the dp slice of the tp shard)."""
    sp = list(param_spec) + [None] * max(0, (zero_dim or 0) + 1
                                         - len(param_spec))
    if zero_dim is not None and sp[zero_dim] != "data":
        sp[zero_dim] = "data" if sp[zero_dim] is None \
            else (sp[zero_dim], "data")
    return tuple(sp)


def join_lm(ranks, key, shape, tree):
    """The global tree of ``key`` ("params", "mu" or "master") from
    every rank's part (``ranks``: one :func:`train_suite` result a rank,
    at one stage), shaped as ``tree``."""
    by = {(r["coords"]["data"], r["coords"]["model"]): r for r in ranks}
    r0 = ranks[0]
    tp = shape["model"]
    leaves = []
    for i, (sp, k, parts) in enumerate(zip(r0["cut_specs"], r0["zero_dims"],
                                           r0["tp_parts"])):
        if key != "params":
            sp = state_spec(sp, k)
        leaves.append(join_shards(lambda co: tree_leaves(by[
            co.get("data", (0, 1))[0], H.tp_rank(co, tp, parts)][key])[i],
            sp, {"model": parts, "data": shape["data"]}))
    return tree_unflatten(tree, leaves)


def lm_tree(np_params):
    """A tree shaped as the ``LM`` tree of ``np_params``."""
    return tree_map(lambda a: None, np_params)
