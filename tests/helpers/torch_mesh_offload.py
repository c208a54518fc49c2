"""Rank bodies for ``tests/test_torch_mesh_offload.py`` and
``tests/test_torch_mesh_checkpoint.py``: what each spawned gloo rank of a
``pp x dp x tp`` mesh runs (``repro_torch.launch.mesh.spawn`` pickles
these by name), and :func:`join`, which lays the ranks' parts of a tree
out as its global numpy leaves.  Imports torch and the port only, so a
rank starts without JAX.

A rank reports each tree it holds as ``(parts, arrays)``: the
:class:`~repro_torch.ft.checkpoint.LeafPart` of every leaf (its global
shape, where the rank's tensor lies in it, whether the rank is its
writer) and the rank's numpy tensor, in ``tree_leaves`` order."""
import dataclasses

import numpy as np
import torch

from repro_torch.bridge import lm_params_from_numpy
from repro_torch.core.pipeline_runtime import (RankShard, init_psum_ef,
                                               rank_params)
from repro_torch.data import SyntheticLM
from repro_torch.ft.checkpoint import LeafPart
from repro_torch.launch.mesh import MESH_RULES
from repro_torch.launch.steps import make_pipeline_train_step, offload_kept
from repro_torch.launch.train import rank_parts, train, train_pipeline
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves

SEQ = 17


def quiet(line):
    """A log that drops every line (picklable, unlike a lambda)."""


def _np(t):
    t = t.detach().cpu() if isinstance(t, torch.Tensor) else t
    return t.numpy().copy() if isinstance(t, torch.Tensor) else \
        np.array(t, copy=True)


def _flat(parts, tree):
    return [(p, _np(a)) for p, a in zip(tree_leaves(parts),
                                        tree_leaves(tree))]


def join(ranks, key):
    """The global numpy leaves of tree ``key`` from every rank's ``(part,
    array)`` list: each writer's array placed at its part."""
    out = None
    for r in ranks:
        leaves = r[key]
        if out is None:
            out = [np.zeros(p.shape, a.dtype) for p, a in leaves]
        for g, (p, a) in zip(out, leaves):
            if p.writes:
                g[p.index] = a
    return out


def part_shards(tc, mesh, spec):
    """The rank's ``(whole, kept, deep)`` :class:`RankShard` of ``tc``'s
    offload plan."""
    plan = tc.plan
    cut = plan.num_chunks - plan.offload.num_offload_chunks

    def of(**kw):
        return RankShard(spec.cfg, spec.layout, mesh.shape, MESH_RULES,
                         mesh.coords, plan.zero_stage, **kw)
    return (of(), of(chunks=slice(0, cut)),
            of(chunks=slice(cut, None), shared=False))


def host_parts(deep_shard, pp):
    """The deep leaves' parts the rank's host optimizer holds."""
    return [LeafPart(tuple(deep_shard.shapes[i]),
                     (pp,) + tuple(deep_shard.part_slices(i, True)),
                     deep_shard.writes(i, True))
            for i in range(len(deep_shard.paths))]


def _source(tc):
    return SyntheticLM(tc.model.vocab_size, tc.shape.seq_len, seed=5)


def offload_run(mesh, tc, np_params, steps):
    """``train_pipeline`` of ``tc`` (offload on) on the rank, from the
    stage-stacked numpy weights and ``SyntheticLM`` seed 5: losses,
    gradient norms, replica checks, and the rank's parts of the weights,
    of the device state (mu, master) and of the host state (mu,
    master)."""
    from repro_torch.launch.train import replica_checks
    checks = []
    out = train_pipeline(
        tc, P=mesh.pp, mesh=mesh, steps=steps,
        params=lm_params_from_numpy(np_params, "cpu"),
        data_source=_source(tc), log=quiet,
        after_step=lambda _, p, o, s: checks.append(
            replica_checks(mesh, p, o, s)))
    from repro_torch.core.pipeline_runtime import make_pipeline_spec
    spec = make_pipeline_spec(tc.model, P=mesh.pp, v=tc.plan.num_chunks,
                              m=tc.plan.num_microbatches,
                              microbatch=tc.plan.microbatch_size,
                              seq_len=tc.shape.seq_len,
                              schedule=tc.plan.schedule)
    whole, kept, deep = part_shards(tc, mesh, spec)
    pp = mesh.coord("pp")
    parts = rank_parts(out["params"], out["opt_state"], whole, kept, pp=pp,
                       first=mesh.rank == 0)
    hopt = out["host_optimizer"]
    hp = host_parts(deep, pp)
    return {"losses": out["losses"], "grad_norms": out["grad_norms"],
            "checks": checks, "coords": dict(mesh.coords),
            "params": _flat(parts["params"], out["params"]),
            "mu": _flat(parts["opt"]["mu"], out["opt_state"]["mu"]),
            "master": _flat(parts["opt"]["master"],
                            out["opt_state"]["master"]),
            "host_mu": list(zip(hp, map(_np, tree_leaves(hopt.mu)))),
            "host_master": list(zip(hp, map(_np,
                                            tree_leaves(hopt.master)))),
            "offload": out["offload"],
            "axis_bytes": out["exchange"]["axis_bytes"]}


def shipment_probe(mesh, tc, np_params, bits):
    """One step of ``tc`` on the rank from the numpy weights, twice: with
    the plan's exact shipment (the rank's fp32 deep gradient sums) and
    with a ``bits``-wide one (``int8_ef`` / ``int16_ef``): the rank's
    shipment, its parts, each leaf's own amax of ``g / m``, and the
    quantized shipment's codes and scales."""
    src = _source(tc)
    toks = src.next_batch(tc.plan.num_microbatches
                          * tc.plan.microbatch_size * mesh.dp)
    batch = {"tokens": torch.from_numpy(toks.reshape(
        tc.plan.num_microbatches, -1, SEQ).astype(np.int64))}
    out = {"coords": dict(mesh.coords)}
    for name, comp in (("exact", "none"),
                       ("quantized", f"int{bits}_ef")):
        plan = dataclasses.replace(tc.plan, grad_compression=comp)
        step, m, _, spec = make_pipeline_train_step(
            tc.model, tc.shape, plan, tc.optimizer, P=mesh.pp,
            device="cpu", mesh=mesh)
        params = rank_params(lm_params_from_numpy(np_params, "cpu"),
                             mesh.coord("pp"), step.shard)
        kept, _ = offload_kept(params, plan, column=True)
        opt = adamw_init(step.kept_shard.zero_views(kept))
        ef = init_psum_ef(spec, params, rank=mesh.coord("pp")) \
            if comp != "none" else None
        res = step(params, opt, batch, ef)
        if comp == "none":
            g = tree_leaves(res.shipment)
            out["parts"] = host_parts(step.deep_shard, mesh.coord("pp"))
            out["g"] = [_np(a) for a in g]
            out["m"] = m
            out["amax"] = [float((a.float() / m).abs().max()) for a in g]
            out["grad_norm"] = float(res.metrics["grad_norm"])
        else:
            codes, scales = res.shipment
            out["codes"] = [_np(a) for a in tree_leaves(codes)]
            out["scales"] = [_np(a) for a in tree_leaves(scales)]
    return out


def offload_suite(mesh, runs, probes):
    """On one rank: each of ``runs`` (``(tc, np_params, steps)``) through
    :func:`offload_run`, then each of ``probes`` (``(tc, np_params,
    bits)``) through :func:`shipment_probe`."""
    torch.set_num_threads(1)
    return {"runs": [offload_run(mesh, *r) for r in runs],
            "probes": [shipment_probe(mesh, *p) for p in probes]}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _params(np_params):
    """The numpy weights as a torch tree, or None: the run draws its own
    from ``tc.seed``."""
    return None if np_params is None else \
        lm_params_from_numpy(np_params, "cpu")


def _state(out, parts):
    return {"params": _flat(parts["params"], out["params"]),
            **{k: _flat(parts["opt"][k], out["opt_state"][k])
               for k in ("mu", "nu", "master")}}


def pipeline_resume(mesh, tc, np_params, ckdir, cutdir, steps, cut):
    """``train_pipeline`` of ``tc`` on the rank: uninterrupted for
    ``steps`` steps; ``cut`` steps into ``cutdir`` (a checkpoint every
    step, left as it is: step ``cut`` is the last); ``cut`` steps into
    ``ckdir`` and resumed from it to ``steps``.  The runs' losses, the
    resumed start, the rank's parts of the state after ``cut`` steps and
    of the final states, and the checkpoint records."""
    from repro_torch.core.pipeline_runtime import make_pipeline_spec
    spec = make_pipeline_spec(tc.model, P=mesh.pp, v=tc.plan.num_chunks,
                              m=tc.plan.num_microbatches,
                              microbatch=tc.plan.microbatch_size,
                              seq_len=tc.shape.seq_len,
                              schedule=tc.plan.schedule)
    whole, kept, _ = part_shards(tc, mesh, spec)
    if not tc.plan.offload.enabled:
        kept = whole
    pp = mesh.coord("pp")

    def run(tc_, n):
        out = train_pipeline(tc_, P=mesh.pp, mesh=mesh, steps=n, log=quiet,
                             params=_params(np_params),
                             data_source=_source(tc_))
        parts = rank_parts(out["params"], out["opt_state"], whole, kept,
                           pp=pp, first=mesh.rank == 0)
        return out, _state(out, parts)
    full, full_state = run(tc, steps)
    out = {"coords": dict(mesh.coords), "full": full["losses"],
           "full_state": full_state}
    cut_run, out["cut_state"] = run(dataclasses.replace(
        tc, checkpoint_dir=cutdir, checkpoint_every=1), cut)
    tck = dataclasses.replace(tc, checkpoint_dir=ckdir, checkpoint_every=1)
    first, _ = run(tck, cut)
    resumed, out["resumed_state"] = run(tck, steps)
    out.update(first=first["losses"], resumed=resumed["losses"],
               start=resumed["start_step"],
               records=cut_run["checkpoint_records"])
    return out


def pipeline_restore(mesh, tc, ckdir, steps):
    """``train_pipeline`` of ``tc`` resumed from ``ckdir`` (written on
    another mesh) to ``steps``, with no periodic save (the directory's
    last checkpoint stays): its losses, start step and records."""
    tck = dataclasses.replace(tc, checkpoint_dir=ckdir,
                              checkpoint_every=10 ** 6)
    out = train_pipeline(tck, P=mesh.pp, mesh=mesh, steps=steps, log=quiet,
                         data_source=_source(tc))
    return {"losses": out["losses"], "start": out["start_step"],
            "coords": dict(mesh.coords),
            "records": out["checkpoint_records"]}


def single_resume(mesh, tc, np_params, ckdir, steps, cut):
    """``train(tc, mesh=)`` on the rank uninterrupted for ``steps`` steps,
    then ``cut`` steps into ``ckdir`` and resumed from it: the runs'
    losses and the resumed start."""
    def run(tc_, n):
        return train(tc_, mesh=mesh, steps=n, log=quiet,
                     params=_params(np_params), data_source=_source(tc_))
    full = run(tc, steps)
    tck = dataclasses.replace(tc, checkpoint_dir=ckdir, checkpoint_every=1)
    first = run(tck, cut)
    resumed = run(tck, steps)
    return {"full": full["losses"], "first": first["losses"],
            "resumed": resumed["losses"], "start": resumed["start_step"]}


def checkpoint_suite(mesh, pipe_runs, reshard, single_runs):
    """On one rank of (2, 2, 2): each of ``pipe_runs`` (``(tc,
    np_params, ckdir, cutdir, steps, cut)``) through
    :func:`pipeline_resume`; the processes regrouped as (2, 1, 4):
    ``reshard`` (``(tc, cutdir, steps)``) through
    :func:`pipeline_restore`; regrouped as (1, 4, 2): each of
    ``single_runs`` (``(tc, np_params, ckdir, steps, cut)``) through
    :func:`single_resume`."""
    torch.set_num_threads(1)
    out = {"pipe": [pipeline_resume(mesh, *r) for r in pipe_runs]}
    out["reshard"] = pipeline_restore(mesh.regroup((2, 1, 4)), *reshard)
    single = mesh.regroup((1, 4, 2))
    out["single"] = [single_resume(single, *r) for r in single_runs]
    return out


def pipe_resume(mesh, tc, ckdir, steps, cut):
    """On one stage of a pipe of ranks (a ``PipeMesh``):
    ``train_pipeline`` of ``tc`` uninterrupted for ``steps`` steps, then
    ``cut`` steps into ``ckdir`` and resumed from it: the runs' losses and
    the resumed start."""
    torch.set_num_threads(1)

    def run(tc_, n):
        return train_pipeline(tc_, P=mesh.P, mesh=mesh, steps=n, log=quiet,
                              data_source=_source(tc_))
    full = run(tc, steps)
    tck = dataclasses.replace(tc, checkpoint_dir=ckdir, checkpoint_every=1)
    first = run(tck, cut)
    resumed = run(tck, steps)
    return {"full": full["losses"], "first": first["losses"],
            "resumed": resumed["losses"], "start": resumed["start_step"],
            "offload": full.get("offload")}
