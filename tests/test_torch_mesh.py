"""Data and tensor parallelism beside the pipe axis, on the CPU: gloo
ranks holding CPU tensors on a ``pp x dp x tp`` mesh
(``repro_torch.launch.mesh.Mesh``), each spawned by
``repro_torch.launch.mesh.spawn(shape=)`` and running its pipe stage on
its dp rows and its tp shard (``tests/helpers/torch_mesh.py`` is the
rank's body).  Reduced tinyllama (4 layers, d 128, 8 heads, 2 K/V heads,
d_ff 352, vocab 512, fp32), chronos_zb P=2 v=2 m=4, two sequences of 17
tokens a dp rank a microbatch; reduced deepseek (8 K/V heads) for tp=4.

Tolerances:

- the gradients gathered from the eight ranks of (2, 2, 2) and the loss
  against ``jax.grad`` of the JAX ``LM.loss`` over the global batch, on
  the JAX package's weights: ``GRAD_TOL`` 1e-5 (absolute, as
  ``tests/test_torch_vshape.py``: the same products summed in another
  order, the tp partial products summed over ranks);
- against the port's one-device executor on the same global batch:
  ``REL`` 1e-5 relative to each leaf's largest element;
- ``train_pipeline`` on the mesh against the one-device run: the losses
  and gradient norms within ``REL``; the dp replicas and the
  tp-replicated leaves bitwise equal after every step;
- the bytes the ranks hand to collectives, by axis, equal to
  ``launch.dryrun.collective_stats(spec, dp, tp).by_axis`` exactly.

One spawn of eight ranks runs every (2, 2, 2) case, one of four the
tp=4 cases; each has its own timeout (``SPAWN_TIMEOUT``)."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.models import LM as JaxLM
from repro_torch.configs import get_reduced
from repro_torch.configs.base import (OptimizerConfig, ParallelPlan,
                                      ShapeConfig, TrainConfig)
from repro_torch.core.pipeline_runtime import unstage_params
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (Mesh, check_mesh, mesh_coords,
                                     mesh_groups, spawn)
from repro_torch.launch.train import train_pipeline
from repro_torch.plan import ExecutablePlan, PlannerQuery, enumerate_points
from repro_torch.tree import tree_leaves, tree_map
from helpers import torch_mesh as H
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPAWN_TIMEOUT = 240          # seconds, each spawn of ranks
GRAD_TOL = 1e-5
REL = 1e-5
SHAPE = {"pp": 2, "data": 2, "model": 2}
STEPS = 3


def _jax_params():
    """The JAX package's ``init_pipeline_params`` weights (P=2, v=2), as
    numpy."""
    cfg = jax_get_reduced("tinyllama-1.1b")
    params, _ = jax_init_pipeline_params(jax.random.key(0), cfg,
                                         JaxStageLayout.build(cfg, 2, 2))
    return jax.tree.map(np.asarray, params)


def _mask():
    """A loss mask whose counts differ between the two dp halves of
    every microbatch (the first half keeps ~80%, the second ~30%)."""
    rng = np.random.default_rng(3)
    u = rng.uniform(size=(4, 4, 16))
    keep = np.concatenate([u[:, :2] > 0.2, u[:, 2:] > 0.7], axis=1)
    return keep.astype(np.float32)


CASES = {
    "jax-weights": H.case(params=_jax_params()),
    "masked": H.case(mask=_mask()),
    "vocab-511": H.case(cfg={"vocab_size": 511}),
}
TP4_CASES = {"deepseek-tp4": H.case("deepseek-7b", dp=1, P=1)}


def _tc(**plan):
    return TrainConfig(
        model=get_reduced("tinyllama-1.1b"),
        shape=ShapeConfig("t", 17, 16, "train"),
        plan=ParallelPlan(**{**dict(schedule="chronos_zb", num_chunks=2,
                                    microbatch_size=2, num_microbatches=4,
                                    kernels="fused"), **plan}),
        optimizer=OptimizerConfig(warmup_steps=1, total_steps=STEPS,
                                  lr=1e-3),
        log_every=1)


def _pick_tc():
    """The planner's best point for reduced tinyllama at pp=2, tp=2 that
    the mesh runs (whole sequences; offload or not, as the planner
    picks), as a TrainConfig."""
    cfg = get_reduced("tinyllama-1.1b")
    q = PlannerQuery(cfg=cfg, pp=2, tp=2, hbm_bytes=1e12, microbatch=1,
                     seq_len=17)
    pts = [p for p in enumerate_points(q) if p.seq_chunks == 1]
    ep = ExecutablePlan(q, max(pts, key=lambda p: p.score))
    plan = dataclasses.replace(ep.parallel_plan(), num_microbatches=ep.m)
    return TrainConfig(model=cfg, shape=ShapeConfig("t", 17, 2 * ep.m,
                                                    "train"),
                       plan=plan, optimizer=OptimizerConfig(
                           warmup_steps=1, total_steps=2),
                       log_every=100), ep


@pytest.fixture(scope="module")
def mesh222():
    names = list(CASES)
    runs = [(_tc(), 2, {"overlap": True, "log": H.quiet}),
            (_tc(), 2, {"overlap": False, "log": H.quiet}),
            (_pick_tc()[0], 2, {"log": H.quiet}),
            (_tc(zero_stage=0), 2, {"overlap": True, "log": H.quiet})]
    outs = spawn(8, H.mesh_suite, args=([CASES[n] for n in names], runs),
                 shape=(2, 2, 2), device="cpu", timeout_s=SPAWN_TIMEOUT)
    return {"grads": {n: [o["grads"][i] for o in outs]
                      for i, n in enumerate(names)},
            "train": [[o["train"][j] for o in outs]
                      for j in range(len(runs))]}


@pytest.fixture(scope="module")
def mesh114():
    names = list(TP4_CASES)
    tc = dataclasses.replace(_tc(), model=get_reduced("deepseek-7b"))
    runs = [(tc, 1, {"log": H.quiet})]
    outs = spawn(4, H.mesh_suite, args=([TP4_CASES[n] for n in names],
                                        runs),
                 shape=(1, 1, 4), device="cpu", timeout_s=SPAWN_TIMEOUT)
    return {"grads": {n: [o["grads"][i] for o in outs]
                      for i, n in enumerate(names)},
            "train": [[o["train"][0] for o in outs]], "tc": tc}


def _rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-12))


def _check_one_device(c, ranks, shape, dp):
    """Every rank's loss, and the gathered gradients, against the
    one-device executor on the global batch; returns the gathered tree."""
    spec = H.spec_of(c)
    got = H.gather(spec, shape, ranks)
    ref = H.one_device(c, dp)
    for r in ranks:
        assert abs(float(r["loss"]) - float(ref["loss"])) \
            <= REL * abs(float(ref["loss"]))
        assert r["n"] == spec.table.m
    assert len({float(r["loss"]) for r in ranks}) == 1
    errs = [_rel(a, b) for a, b in zip(tree_leaves(got),
                                       tree_leaves(ref["g"]), strict=True)]
    assert max(errs) <= REL, errs
    return spec, got


def _check_bytes(c, ranks, dp, tp):
    spec = H.spec_of(c)
    want = dryrun.collective_stats(spec, dp, tp, masked=c["mask"]
                                   is not None, update=False).by_axis
    for ax in ("pp", "data", "model"):
        assert sum(r["bytes"][ax] for r in ranks) == want[ax], ax


@pytest.mark.parametrize("name", list(CASES))
def test_eight_ranks_match_the_one_device_executor(name, mesh222):
    """pp 2 x dp 2 x tp 2 on the JAX weights, with a mask whose counts
    differ across the dp ranks (each microbatch's loss normalized by the
    global microbatch's count, all-reduced over dp), and with a vocab tp
    does not divide (511: embedding and head replicated, their layers
    unsplit)."""
    ranks = mesh222["grads"][name]
    assert sorted(tuple(r["coords"].values()) for r in ranks) == \
        [mesh_coords(r, 2, 2, 2) for r in range(8)]
    _check_one_device(CASES[name], ranks, SHAPE, 2)
    _check_bytes(CASES[name], ranks, 2, 2)


_jax_vg = jax.jit(jax.value_and_grad(
    lambda p, tokens: sum(JaxLM(jax_get_reduced("tinyllama-1.1b")).loss(
        p, {"tokens": tokens[i]})[0] for i in range(tokens.shape[0]))))


def test_eight_ranks_match_jax_autodiff(mesh222):
    """The gathered gradients and the loss against ``jax.grad`` of the
    JAX ``LM.loss`` summed over the global microbatches (the mesh's loss
    is their mean)."""
    c = CASES["jax-weights"]
    spec = H.spec_of(c)
    got = H.gather(spec, SHAPE, mesh222["grads"]["jax-weights"])
    params = H.full_params(c, spec)
    loss, ref = _jax_vg(jax.tree.map(jnp.asarray, tree_map(
        lambda a: a.numpy().copy(), unstage_params(params, spec.layout))),
        c["tokens"].astype(np.int32))
    ours = tree_leaves(unstage_params(got, spec.layout))
    theirs = jax.tree.leaves(ref)
    assert len(ours) == len(theirs)
    errs = [float(np.abs(a.numpy() - np.asarray(b)).max())
            for a, b in zip(ours, theirs)]
    m = spec.table.m
    e_loss = abs(float(mesh222["grads"]["jax-weights"][0]["loss"])
                 - float(loss) / m)
    print(f"(2,2,2) vs jax.grad: max |d grad| {max(errs):.3e}, "
          f"|d loss| {e_loss:.3e}")
    assert max(errs) <= GRAD_TOL and e_loss <= GRAD_TOL


@pytest.mark.parametrize("run,zero_stage", [(0, 1), (1, 1), (3, 0)],
                         ids=["overlap", "sync", "zero0"])
def test_train_pipeline_on_the_mesh_tracks_one_device(run, zero_stage,
                                                       mesh222):
    """Three steps of ``train_pipeline(mesh=)`` against the one-device
    run on the same global batches: ZeRO-1 (AdamW on each dp slice, the
    weights all-gathered over dp) with the overlapped and the synchronous
    exchange, and ZeRO stage 0 (every dp rank updates whole leaves; the
    clip norm counts a dp-whole leaf on dp coordinate 0 only).  Losses
    and gradient norms within ``REL``, the replicas (every weight over
    dp, the tp-replicated weights and masters over tp, the shared leaves
    over pp) bitwise equal after every step, the collective bytes of
    every step the reckoning's (no all-gather at stage 0)."""
    tc = _tc(zero_stage=zero_stage)
    one = train_pipeline(dataclasses.replace(tc, plan=dataclasses.replace(
        tc.plan, microbatch_size=4)), P=2, device="cpu", log=H.quiet)
    ranks = mesh222["train"][run]
    spec = H.spec_of(H.case())
    coll = dryrun.collective_stats(spec, 2, 2, update=True,
                                   zero_stage=zero_stage)
    assert (coll.bytes_by_kind["all-gather-dp"] > 0) == (zero_stage == 1)
    want = coll.by_axis
    for r in ranks:
        assert r["steps"] == STEPS
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=REL,
                                   atol=0)
        np.testing.assert_allclose(r["grad_norms"], one["grad_norms"],
                                   rtol=REL, atol=0)
        assert r["replicas_equal"] == [True] * STEPS
        assert all(set(c) == {"pp", "data", "model"}
                   for c in r["replica_checks"])
    for step in range(STEPS):
        for ax in ("pp", "data", "model"):
            assert sum(r["exchange"]["axis_bytes"][step][ax]
                       for r in ranks) == want[ax], (step, ax)


def test_a_planner_pick_at_tp2_trains_on_the_mesh(mesh222):
    """The planner's pick at pp=2, tp=2 (its ``parallel_plan``, with
    ``zero_stage`` 1) trains two steps on the (2, 2, 2) mesh: finite
    losses equal on every rank, the replicas equal."""
    tc, ep = _pick_tc()
    assert ep.query.tp == 2 and tc.plan.zero_stage == 1
    ranks = mesh222["train"][2]
    losses = ranks[0]["losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(r["losses"] == losses for r in ranks)
    assert all(r["replicas_equal"] == [True, True] for r in ranks)


def test_tp4_at_pp1_matches_one_device(mesh114):
    """tp=4 at pp=1 (reduced deepseek, 8 query and 8 K/V heads: two of
    each a rank): gradients and loss against the one-device executor,
    the collective bytes, and three training steps against the one-device
    run."""
    c = TP4_CASES["deepseek-tp4"]
    ranks = mesh114["grads"]["deepseek-tp4"]
    shape = {"pp": 1, "data": 1, "model": 4}
    _check_one_device(c, ranks, shape, 1)
    _check_bytes(c, ranks, 1, 4)
    one = train_pipeline(mesh114["tc"], P=1, device="cpu", log=H.quiet)
    for r in mesh114["train"][0]:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=REL,
                                   atol=0)
        assert r["replicas_equal"] == [True] * STEPS


def test_spawn_runs_on_the_card_unless_told(monkeypatch):
    """``spawn`` starts CUDA ranks unless ``device="cpu"``, as the other
    entry points do; CUDA ranks without a card raise before a process
    starts, naming ``device='cpu'``."""
    for fn in (spawn, train_pipeline):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn(8, print, shape=(2, 2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        check_mesh(2, backend="gloo", device="cuda")
    check_mesh(2, backend="gloo", device="cpu")


def test_mesh_groups_and_rank_order():
    """Rank ``(p * dp + d) * tp + t`` (``make_host_study_mesh``'s
    ``("pp", "data", "model")`` order); each axis's groups partition the
    ranks; a mesh's pipe names its stages' global ranks."""
    groups = mesh_groups(2, 2, 2)
    for ax in groups:
        assert sorted(r for g in groups[ax] for r in g) == list(range(8))
    assert groups["model"][0] == [0, 1] and groups["data"][0] == [0, 2]
    assert groups["pp"][0] == [0, 4]
    m = Mesh(2, 2, 2, 5, "gloo", "cpu")
    assert m.coords == {"pp": 1, "data": 0, "model": 1}
    assert m.pipe.rank == 1 and m.pipe.ranks == (1, 5)
    assert m.pipe.global_rank(0) == 1 and m.shape == SHAPE
