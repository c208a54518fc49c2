"""The port's elastic recovery against the reference and against its own
uninterrupted runs (CPU, reduced sizes):

- ``remap_blocks_elastic`` equals the JAX function bitwise on random
  trees over P in {2, 3, 4, 8}, both placements, 2, 5 and 12 layers and
  a config with period > 1, with and without ``init_blocks``; the tagged
  layer check and the src -> dst -> src identity of the reference's own
  test;
- ``migrate_checkpoint`` P=4 -> P=3: every real layer of params, mu, nu
  and master bitwise the original's, padding from a fresh init and zero
  moments; the restore guard and the offload assertion;
- the drivers: ``train()`` resumed equals an uninterrupted ``train()``
  bitwise; ``train()`` resumes a JAX ``train()`` checkpoint and follows
  the JAX run within ``_train_pair``'s bounds; ``train_elastic`` through
  the reference drill's fault list (P 4 -> 3 -> 4) step-count exact
  within 1e-5 of the uninterrupted run (the reference's bound); a hung
  collective through the fake-clock watchdog; a straggler -> restart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import get_reduced as jax_get_reduced
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    remap_blocks_elastic as jax_remap_elastic
from repro.core.placement import get_placement as jax_get_placement
from repro.ft import Checkpointer as JaxCheckpointer
from repro.launch import train as jax_train_module
from repro.models import LM as JaxLM
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import base as TB
from repro_torch.configs import get_reduced
from repro_torch.core.layout import StageLayout
from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                               remap_blocks_elastic,
                                               unstage_params)
from repro_torch.core.placement import PLACEMENTS, get_placement
from repro_torch.ft import Checkpointer
from repro_torch.ft.elastic_pipeline import (_build_layout,
                                             migrate_checkpoint,
                                             train_elastic)
from repro_torch.ft.inject import (CheckpointCrash, DeviceJoin, DeviceLoss,
                                   FaultInjector, HungCollective, Straggler)
from repro_torch.launch import train as train_module
from repro_torch.launch.train import train, train_pipeline
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

QUIET = lambda *_: None  # noqa: E731
PLACEMENT_NAMES = sorted(PLACEMENTS)


# ---------------------------------------------------------------------------
# remap_blocks_elastic against the JAX function
# ---------------------------------------------------------------------------

def _cfgs(arch="tinyllama-1.1b", layers=None):
    cfg, jcfg = get_reduced(arch), jax_get_reduced(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    return cfg, jcfg


def _layouts(cfg, jcfg, P, placement):
    jpl = None if placement == "interleaved" else \
        jax_get_placement(placement, P, 2)
    return (StageLayout.build(cfg, P, 2, get_placement(placement, P, 2)),
            JaxStageLayout.build(jcfg, P, 2, placement=jpl))


def _random_blocks(layout, rng, shapes=((3,), (2, 5))):
    """One tree per period position, leaves [P, v, M, *shape] fp32."""
    return [{f"w{i}": rng.standard_normal(
        (layout.P, layout.v, layout.M) + s).astype(np.float32)
        for i, s in enumerate(shapes)} for _ in range(layout.period)]


def _remap_pair(src, dst, jsrc, jdst, blocks, init):
    tt = [tree_map(torch.from_numpy, b) for b in blocks]
    ti = None if init is None else [tree_map(torch.from_numpy, b)
                                    for b in init]
    ji = None if init is None else jax.tree.map(jnp.asarray, init)
    got = remap_blocks_elastic(tt, src, dst, init_blocks=ti)
    want = jax_remap_elastic(jax.tree.map(jnp.asarray, blocks), jsrc, jdst,
                             init_blocks=ji)
    return got, want


@pytest.mark.parametrize("p_src", [2, 3, 4, 8])
@pytest.mark.parametrize("p_dst", [2, 3, 4, 8])
def test_remap_elastic_matches_jax(p_src, p_dst):
    """Every placement pair and 2, 5 and 12 layers (plus reduced jamba,
    period 8): bitwise the JAX gather, with ``init_blocks`` and, where
    the destination has no position outside the source's span, without
    (where it has, both refuse)."""
    rng = np.random.default_rng(p_src * 10 + p_dst)
    cases = [("tinyllama-1.1b", n) for n in (2, 5, 12)] + \
        [("jamba-v0.1-52b", None)]
    for arch, layers in cases:
        cfg, jcfg = _cfgs(arch, layers)
        for a in PLACEMENT_NAMES:
            for b in PLACEMENT_NAMES:
                src, jsrc = _layouts(cfg, jcfg, p_src, a)
                dst, jdst = _layouts(cfg, jcfg, p_dst, b)
                blocks = _random_blocks(src, rng)
                init = _random_blocks(dst, rng)
                for ini in (init, None):
                    if ini is None and dst.L_pad > src.L_pad:
                        with pytest.raises(AssertionError):
                            remap_blocks_elastic(
                                [tree_map(torch.from_numpy, x)
                                 for x in blocks], src, dst)
                        with pytest.raises(AssertionError):
                            jax_remap_elastic(blocks, jsrc, jdst)
                        continue
                    got, want = _remap_pair(src, dst, jsrc, jdst, blocks,
                                            ini)
                    for x, y in zip(tree_leaves(got), jax.tree.leaves(want)):
                        assert x.numpy().tobytes() == \
                            np.asarray(y).tobytes(), (arch, a, b)


def _tagged_blocks(layout):
    """Block stacks whose leaf value at (d, c, mi) *is* the global layer
    index that position holds (the reference test's tagging)."""
    out = []
    for j in range(layout.period):
        g = torch.zeros((layout.P, layout.v, layout.M))
        for d in range(layout.P):
            for c in range(layout.v):
                for mi in range(layout.M):
                    g[d, c, mi] = layout.global_idx(
                        d, c, mi * layout.period + j)
        out.append({"w": g})
    return out


@pytest.mark.parametrize("layers", [2, 5, 12])
def test_remap_elastic_assignment_and_roundtrip(layers):
    """For every placement pair and P in {2, 3, 4, 8}: a remap puts each
    global layer exactly where the destination layout says it lives, and
    src -> dst -> src is the identity (padding positions included: they
    refill from the destination's init tagging)."""
    cfg = _cfgs(layers=layers)[0]
    for p_src in (2, 3, 4, 8):
        for p_dst in (2, 3, 4, 8):
            for a in PLACEMENT_NAMES:
                for b in PLACEMENT_NAMES:
                    src = StageLayout.build(cfg, p_src, 2,
                                            get_placement(a, p_src, 2))
                    dst = StageLayout.build(cfg, p_dst, 2,
                                            get_placement(b, p_dst, 2))
                    t_src, t_dst = _tagged_blocks(src), _tagged_blocks(dst)
                    got = remap_blocks_elastic(t_src, src, dst,
                                               init_blocks=t_dst)
                    assert all(torch.equal(x["w"], y["w"])
                               for x, y in zip(got, t_dst))
                    back = remap_blocks_elastic(got, dst, src,
                                                init_blocks=t_src)
                    assert all(torch.equal(x["w"], y["w"])
                               for x, y in zip(back, t_src))


# ---------------------------------------------------------------------------
# migrate_checkpoint
# ---------------------------------------------------------------------------

def _pipe_tc(ckpt_dir, layers=8, steps=4, **plan):
    cfg = dataclasses.replace(get_reduced("tinyllama-1.1b"),
                              num_layers=layers)
    return TB.TrainConfig(
        model=cfg, shape=TB.ShapeConfig("s", 18, 8, "train"),
        plan=TB.ParallelPlan(**{**dict(
            schedule="chronos", num_chunks=2, microbatch_size=2,
            num_microbatches=4, kernels="fused"), **plan}),
        optimizer=TB.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=steps, schedule="constant"),
        log_every=1000, checkpoint_every=3, checkpoint_dir=ckpt_dir,
        keep_checkpoints=2)


def test_migrate_checkpoint_p4_to_p3(tmp_path):
    """A trained P=4 checkpoint (8 layers: L_pad 8 -> 12 at P=3) migrated
    to P=3: unstaged params, mu, nu and master bitwise the original's;
    the 4 padding layers hold the fresh init (master: its fp32 copy) and
    zero moments; the re-save carries the new layout."""
    tc = _pipe_tc(str(tmp_path), steps=2)
    out = train_pipeline(tc, P=4, device="cpu", log=QUIET)
    lay4, lay3 = _build_layout(tc, 4), _build_layout(tc, 3)
    assert (lay4.L_pad, lay3.L_pad) == (8, 12)
    ck = Checkpointer(str(tmp_path))
    restore_s, remap_s = migrate_checkpoint(ck, tc, lay3, device="cpu",
                                            log=QUIET)
    assert restore_s > 0 and remap_s > 0
    assert ck.read_extra()["layout"] == {
        "P": 3, "v": 2, "schedule": "chronos", "placement": "interleaved"}
    fresh = init_pipeline_params(torch.Generator().manual_seed(tc.seed),
                                 tc.model, lay3, "cpu")
    params3 = init_pipeline_params(torch.Generator().manual_seed(99),
                                   tc.model, lay3, "cpu")
    opt3 = adamw_init(params3)
    ck.restore_into({"params": params3, "opt": opt3})
    trees = [(out["params"], params3)] + [
        (out["opt_state"][k], opt3[k]) for k in ("mu", "nu", "master")]
    for old, new in trees:
        a, b = unstage_params(old, lay4), unstage_params(new, lay3)
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(opt3["step"]) == 2
    pad = [(d, c, w) for d in range(3) for c in range(2)
           for w in range(lay3.K) if lay3.global_idx(d, c, w) >= lay3.L]
    assert len(pad) == 4
    for key, want in (("params", fresh), ("master", fresh),
                      ("mu", None), ("nu", None)):
        tree = params3 if key == "params" else opt3[key]
        for leaf, ref in zip(tree_leaves(tree["blocks"]),
                             tree_leaves(fresh["blocks"])):
            for d, c, w in pad:
                got = leaf[d, c, w]
                exp = torch.zeros_like(got) if want is None else \
                    ref[d, c, w].to(got.dtype)
                assert torch.equal(got, exp), key


def test_restore_guard_and_offload_assertion(tmp_path):
    """A P=4 checkpoint restored at P=3 without migration raises; an
    offload plan refuses migration; the same layout migrates nothing."""
    tc = _pipe_tc(str(tmp_path), steps=1)
    train_pipeline(tc, P=4, device="cpu", log=QUIET)
    with pytest.raises(RuntimeError, match="migrate it first"):
        train_pipeline(tc, P=3, device="cpu", log=QUIET)
    ck = Checkpointer(str(tmp_path))
    assert migrate_checkpoint(ck, tc, _build_layout(tc, 4), device="cpu",
                              log=QUIET) == (0.0, 0.0)
    off = dataclasses.replace(tc, plan=dataclasses.replace(
        tc.plan, offload=TB.OffloadConfig(enabled=True,
                                          num_offload_chunks=1)))
    with pytest.raises(AssertionError, match="offloaded"):
        migrate_checkpoint(ck, off, _build_layout(tc, 3), device="cpu",
                           log=QUIET)


def test_restore_guard_placement(tmp_path):
    """A chronos_zb checkpoint (interleaved placement) resumed under v_min
    at the same P and v (fold-back placement) raises; migrated first, it
    resumes with every layer of params, mu, nu and master bitwise where
    it was (unstaged)."""
    tc = _pipe_tc(str(tmp_path), layers=4, steps=1, schedule="chronos_zb")
    vm = dataclasses.replace(tc, plan=dataclasses.replace(
        tc.plan, schedule="v_min"))
    out = train_pipeline(tc, P=2, device="cpu", log=QUIET)
    with pytest.raises(RuntimeError, match="migrate it first"):
        train_pipeline(vm, P=2, device="cpu", log=QUIET)
    lay_zb, lay_vm = _build_layout(tc, 2), _build_layout(vm, 2)
    assert (lay_zb.pl.name, lay_vm.pl.name) == ("interleaved", "vshape")
    ck = Checkpointer(str(tmp_path))
    migrate_checkpoint(ck, vm, lay_vm, device="cpu", log=QUIET)
    res = train_pipeline(vm, P=2, device="cpu", log=QUIET)
    assert (res["start_step"], res["steps"]) == (1, 0)
    trees = [(out["params"], res["params"])] + [
        (out["opt_state"][k], res["opt_state"][k])
        for k in ("mu", "nu", "master")]
    for old, new in trees:
        a, b = unstage_params(old, lay_zb), unstage_params(new, lay_vm)
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

def _single_tc(ckpt_dir, every=500):
    return TB.TrainConfig(
        model=get_reduced("tinyllama-1.1b"),
        shape=TB.ShapeConfig("t", 32, 4, "train"),
        plan=TB.ParallelPlan(num_chunks=2, microbatch_size=2,
                             recompute=TB.RecomputeConfig("chronos"),
                             kernels="fused"),
        optimizer=TB.OptimizerConfig(warmup_steps=1, total_steps=5,
                                     lr=1e-3),
        seed=5, log_every=1, checkpoint_every=every,
        checkpoint_dir=ckpt_dir)


def test_train_resume_is_bitwise(tmp_path):
    """5 steps of ``train()`` equal 3 steps, a new call on the same
    directory (restore at step 3) and 2 more: losses, the fp32 masters
    and the data cursor, bitwise."""
    full = train(_single_tc(str(tmp_path / "a")), device="cpu", log=QUIET)
    tc = _single_tc(str(tmp_path / "b"), every=1)
    first = train(tc, device="cpu", steps=3, log=QUIET)
    assert Checkpointer(tc.checkpoint_dir).all_steps() == [1, 2, 3]
    rest = train(tc, device="cpu", steps=5, log=QUIET)
    assert rest["start_step"] == 3 and rest["steps"] == 2
    assert first["losses"] + rest["losses"] == full["losses"]
    for a, b in zip(tree_leaves(full["opt_state"]),
                    tree_leaves(rest["opt_state"])):
        assert torch.equal(a, b)
    assert Checkpointer(tc.checkpoint_dir).read_extra()["data"] == \
        Checkpointer(str(tmp_path / "a")).read_extra()["data"]


LOSS_TOL = 1e-5           # tests/test_torch_train_single.py's bounds
W_TOL, W_FRAC = 1e-6, 1e-3


def test_train_resumes_a_jax_checkpoint(tmp_path):
    """The JAX ``train()`` runs 3 steps and saves; the port's ``train()``
    restores that checkpoint (weights, AdamW state, step, data cursor)
    and runs steps 3-4; held against the JAX ``train()`` run to 5 steps:
    losses within LOSS_TOL, final masters within W_TOL but for a W_FRAC
    share (``_train_pair``'s bounds)."""
    seed, shape = 5, dict(name="t", seq_len=32, global_batch=4,
                          kind="train")
    ocfg = dict(warmup_steps=1, total_steps=5, lr=1e-3)

    def jtc(d):
        return JB.TrainConfig(
            model=jax_get_reduced("tinyllama-1.1b"),
            shape=JB.ShapeConfig(**shape),
            plan=JB.ParallelPlan(num_chunks=2, microbatch_size=2,
                                 recompute=JB.RecomputeConfig("chronos")),
            optimizer=JB.OptimizerConfig(**ocfg), seed=seed, log_every=1,
            checkpoint_dir=d)
    jax_train_module.train(jtc(str(tmp_path / "j3")), steps=3,
                           log=QUIET)
    jout = jax_train_module.train(jtc(str(tmp_path / "j5")), steps=5,
                                  log=QUIET)
    jp, _ = JaxLM(jax_get_reduced("tinyllama-1.1b")).init(
        jax.random.key(seed))
    final, _ = JaxCheckpointer(str(tmp_path / "j5")).restore(
        {"params": jp, "opt": jax_adamw_init(jp)})

    tc = TB.TrainConfig(
        model=get_reduced("tinyllama-1.1b"), shape=TB.ShapeConfig(**shape),
        plan=TB.ParallelPlan(num_chunks=2, microbatch_size=2,
                             recompute=TB.RecomputeConfig("chronos"),
                             kernels="fused"),
        optimizer=TB.OptimizerConfig(**ocfg), seed=seed, log_every=1,
        checkpoint_dir=str(tmp_path / "j3"))
    out = train(tc, device="cpu", steps=5, log=QUIET)
    assert out["start_step"] == 3
    np.testing.assert_allclose(out["losses"], jout["losses"][3:], rtol=0,
                               atol=LOSS_TOL)
    d_w = np.concatenate([
        np.abs(a.numpy() - np.asarray(b)).ravel() for a, b in zip(
            tree_leaves(out["opt_state"]["master"]),
            jax.tree.leaves(final["opt"]["master"]))])
    frac = float((d_w > W_TOL).mean())
    print(f"steps 3-4 after a JAX checkpoint: max |port - jax| master "
          f"{d_w.max():.3e}, beyond {W_TOL:g}: {frac:.2e}")
    assert frac <= W_FRAC and d_w.max() <= 2 * ocfg["lr"] * 2
    assert int(out["opt_state"]["step"]) == int(final["opt"]["step"]) == 5


N_STEPS, CKPT_EVERY = 12, 3
FAIL_STEP = N_STEPS // 2 + 1                  # the reference drill's
JOIN_STEP = FAIL_STEP + 2
ELASTIC_TOL = 1e-5                            # the reference drill's bound


def _elastic_tc(ckpt_dir):
    tc = _pipe_tc(ckpt_dir, layers=2, steps=N_STEPS, num_microbatches=0)
    return dataclasses.replace(tc, checkpoint_every=CKPT_EVERY)


def test_train_elastic_drill_is_step_count_exact(tmp_path):
    """The reference drill's fault list at P=4 (a checkpoint writer dying
    before its rename, a stage lost at step 7, back at step 9): P
    4 -> 3 -> 4, both recoveries with restore and remap, every step's
    loss within ELASTIC_TOL of the uninterrupted run (measured: bitwise
    on the CPU), and the final state equal to the LATEST checkpoint."""
    base = train_elastic(_elastic_tc(str(tmp_path / "a")), n_devices=4,
                         device="cpu", log=QUIET)
    faults = [CheckpointCrash(step=CKPT_EVERY, at="rename"),
              DeviceLoss(step=FAIL_STEP, device=1),
              DeviceJoin(step=JOIN_STEP, device=1)]
    ft = train_elastic(_elastic_tc(str(tmp_path / "b")), n_devices=4,
                       faults=faults, device="cpu", log=QUIET)
    assert sorted(base["loss_by_step"]) == list(range(N_STEPS))
    assert sorted(ft["loss_by_step"]) == list(range(N_STEPS))
    assert [i["P"] for i in ft["incarnations"]] == [4, 3, 4]
    assert [(r.kind, r.p_from, r.p_to) for r in ft["recoveries"]] == [
        ("device_loss", 4, 3), ("scale_up", 3, 4)]
    assert all(r.restore_s > 0 and r.remap_s > 0 for r in ft["recoveries"])
    err = max(abs(base["loss_by_step"][s] - ft["loss_by_step"][s])
              for s in range(N_STEPS))
    print(f"elastic drill: max |faulted - baseline| loss {err:.3e}")
    assert err <= ELASTIC_TOL
    assert [type(e["fault"]).__name__ for e in ft["events"]] == [
        "CheckpointCrash", "DeviceLoss", "DeviceJoin"]
    saves = [r for r in ft["checkpoint_records"] if r["op"] == "save"]
    assert [r.get("error") is not None for r in saves].count(True) == 1
    tree = {"params": ft["params"], "opt": ft["opt_state"]}
    restored, _ = Checkpointer(str(tmp_path / "b")).restore(tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert torch.equal(a, b)


def test_train_elastic_hung_collective(tmp_path):
    """A 30 s stall is tolerated; a 700 s hang trips the 600 s watchdog
    on the injector's fake clock: the incarnation dies at that step, the
    pipeline re-plans at P=3, and every step has its loss."""
    faults = [HungCollective(step=2, device=0, hang_s=30.0),
              HungCollective(step=4, device=2, hang_s=700.0)]
    tc = dataclasses.replace(_elastic_tc(str(tmp_path)),
                             optimizer=dataclasses.replace(
                                 _elastic_tc(None).optimizer, total_steps=6))
    out = train_elastic(tc, n_devices=4, faults=faults, device="cpu",
                        log=QUIET)
    assert [i["P"] for i in out["incarnations"]] == [4, 3]
    assert out["incarnations"][0]["status"] == "hung_collective"
    assert [(r.kind, r.p_from, r.p_to) for r in out["recoveries"]] == [
        ("hung_collective", 4, 3)]
    assert sorted(out["loss_by_step"]) == list(range(6))


class _FakeTime:
    """``time`` for the driver: every call advances one second, so each
    step's measured time is the same count of calls."""

    def __init__(self):
        self.now = 0.0

    def time(self):
        self.now += 1.0
        return self.now


def test_straggler_restarts_the_pipeline(tmp_path, monkeypatch):
    """A 3-step straggler (10x reported time) after 6 healthy steps walks
    the health monitor to CHECKPOINT_NOW, then RESTART: the run returns
    status "restart" at the third slow step, saved at the step reached;
    under ``train_elastic`` it restarts at the same P and completes."""
    monkeypatch.setattr(train_module, "time", _FakeTime())
    tc = _elastic_tc(str(tmp_path / "a"))
    inj = FaultInjector([Straggler(step=6, n_steps=3, factor=10.0)])
    out = train_pipeline(tc, P=2, device="cpu", injector=inj, log=QUIET)
    assert out["status"] == "restart" and out["next_step"] == 9
    ck = Checkpointer(tc.checkpoint_dir)
    assert ck.all_steps() == [6, 9]
    el = train_elastic(_elastic_tc(str(tmp_path / "b")), n_devices=2,
                       faults=[Straggler(step=6, n_steps=3, factor=10.0)],
                       device="cpu", log=QUIET)
    assert [(i["P"], i["status"]) for i in el["incarnations"]] == [
        (2, "restart"), (2, "complete")]
    assert [(r.kind, r.step) for r in el["recoveries"]] == [
        ("straggler_restart", 9)]
    assert sorted(el["loss_by_step"]) == list(range(N_STEPS))
