"""The port's fault-tolerance and data modules against the reference's:
the ``Checkpointer`` (its own crash-consistency suite, and the on-disk
format crossing both ways bitwise), the decision logic (``plan_mesh``,
``simulate_failures``, ``HealthMonitor``, ``FaultInjector``) decision for
decision, and the token shards read alike by both packages.

Every comparison here is exact (bitwise or equal decisions): the modules
move bytes and make discrete choices, so there is no tolerance to state.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.hypcompat import given, settings, st

from repro.configs import get_reduced as jax_get_reduced
from repro.data.tokenshards import TokenShardDataset as JaxShards
from repro.data.tokenshards import \
    write_synthetic_shards as jax_write_shards
from repro.ft import checkpoint as JC
from repro.ft import elastic as JE
from repro.ft import health as JH
from repro.ft import inject as JI
from repro.models import LM as JaxLM
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_reduced
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data import (ShardWriter, SyntheticLM, TokenShardDataset,
                              write_synthetic_shards)
from repro_torch.ft import checkpoint as TC
from repro_torch.ft import elastic as TE
from repro_torch.ft import health as TH
from repro_torch.ft import inject as TI
from repro_torch.models import LM
from repro_torch.optim import adamw_init, adamw_update, cast_like
from repro_torch.tree import tree_leaves
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# Checkpointer: the reference's own suite, on torch trees
# ---------------------------------------------------------------------------

def _tree():
    return {"w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
            "opt": {"mu": torch.ones((2, 2), dtype=torch.float32),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    return {"w": torch.zeros_like(tree["w"]),
            "opt": {k: torch.zeros_like(v) for k, v in tree["opt"].items()}}


def _assert_same(a_tree, b_tree):
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_roundtrip_bf16(tmp_path):
    ck = TC.Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    ck.save(3, tree, extra={"data": {"position": 42}})
    restored, extra = ck.restore(_zeros_like(tree))
    _assert_same(tree, restored)
    assert extra["data"]["position"] == 42
    live = _zeros_like(tree)
    w = live["w"]
    assert ck.restore_into(live)["data"]["position"] == 42
    assert live["w"] is w                       # in place
    _assert_same(tree, live)
    with pytest.raises(ValueError, match="checkpoint holds"):
        ck.restore_into({**live, "w": torch.zeros((4, 3), dtype=torch.bfloat16)})


def test_checkpoint_async_and_gc(tmp_path):
    ck = TC.Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        ck.save_async(s, tree)
    ck.wait()
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4
    assert [r["step"] for r in ck.records] == [1, 2, 3, 4]
    assert all(r["write_s"] is not None for r in ck.records)


def test_save_async_snapshots_before_returning(tmp_path):
    """The drivers overwrite their tensors at the next step: what
    ``save_async`` writes is the tree as it was when it was called."""
    ck = TC.Checkpointer(str(tmp_path))
    tree = _tree()
    want = {"w": tree["w"].clone(),
            "opt": {k: v.clone() for k, v in tree["opt"].items()}}
    ck.save_async(1, tree)
    tree["w"].add_(1)
    tree["opt"]["mu"].mul_(3)
    ck.wait()
    _assert_same(want, ck.restore(_zeros_like(want))[0])


def test_checkpoint_survives_partial_write(tmp_path):
    ck = TC.Checkpointer(str(tmp_path), keep=3)
    ck.save(1, _tree())
    # simulate a crashed writer: stray tmp dir must not break restore
    os.makedirs(os.path.join(str(tmp_path), "tmp.deadbeef"))
    restored, _ = ck.restore(_zeros_like(_tree()))
    assert ck.latest_step() == 1
    assert float(restored["opt"]["mu"].sum()) == 4.0


def test_kill_restart_resume_equivalence(tmp_path):
    """Training-state checkpoint/restore mid-run gives identical
    continuation (optimizer + data stream), bitwise."""
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=0, schedule="constant")
    params = {"w": torch.ones((4, 4))}
    state = adamw_init(params)
    gen = SyntheticLM(vocab_size=97, seq_len=8, seed=5)

    def one_step(params, state, gen):
        batch = torch.from_numpy(gen.next_batch(2).astype(np.float32))
        g = {"w": (batch[:, :4] @ torch.ones((4, 4))).repeat(2, 1) * 1e-3}
        master, state, _ = adamw_update(g, state, cfg)
        return cast_like(master, params), state

    for _ in range(3):
        params, state = one_step(params, state, gen)
    ck = TC.Checkpointer(str(tmp_path))
    ck.save(3, {"params": params, "opt": state}, extra=gen.state())
    for _ in range(2):
        params, state = one_step(params, state, gen)

    p2 = {"w": torch.zeros((4, 4))}
    s2 = adamw_init(p2)
    extra = ck.restore_into({"params": p2, "opt": s2})
    gen2 = SyntheticLM(vocab_size=97, seq_len=8)
    gen2.load_state(extra)
    for _ in range(2):
        p2, s2 = one_step(p2, s2, gen2)
    assert torch.equal(p2["w"], params["w"])
    _assert_same(s2, state)


def _assert_restorable(ck, want_step, want_tree):
    """LATEST resolves to ``want_step`` and a full restore round-trips."""
    assert ck.latest_step() == want_step
    _assert_same(want_tree, ck.restore(_zeros_like(want_tree))[0])


def test_checkpoint_crash_consistency_random_offsets(tmp_path):
    """Writer death at a random byte offset inside any leaf file never
    corrupts the published history: LATEST keeps resolving to the last
    *complete* step and it restores fully."""
    ck = TC.Checkpointer(str(tmp_path), keep=3)
    tree = _tree()
    ck.save(1, tree)
    max_bytes = max(x.numel() * x.element_size() for x in tree_leaves(tree))
    rng = np.random.default_rng(0xC0FFEE)
    for trial in range(8):
        off = int(rng.integers(0, max_bytes + 16))
        TI.install_checkpoint_crash(at="bytes", offset=off)
        with pytest.raises(TI.InjectedCheckpointCrash):
            ck.save(2 + trial, tree)
        _assert_restorable(ck, 1, tree)
    # the crash patch is one-shot: the next save lands durably and GC
    # sweeps the dead writers' tmp dirs
    ck.save(50, tree)
    _assert_restorable(ck, 50, tree)
    assert not [d for d in os.listdir(str(tmp_path))
                if d.startswith("tmp.")]


def test_checkpoint_crash_between_write_and_rename(tmp_path):
    """Writer death *after* the tmp dir is fully written but *before*
    the atomic rename publishes it: the unpublished dir is invisible to
    LATEST/restore and a retry succeeds."""
    ck = TC.Checkpointer(str(tmp_path), keep=3)
    tree = _tree()
    ck.save(1, tree)
    TI.install_checkpoint_crash(at="rename")
    with pytest.raises(TI.InjectedCheckpointCrash):
        ck.save(2, tree)
    assert [d for d in os.listdir(str(tmp_path)) if d.startswith("tmp.")]
    _assert_restorable(ck, 1, tree)
    ck.save(2, tree)                       # one-shot patch: retry lands
    _assert_restorable(ck, 2, tree)
    assert not [d for d in os.listdir(str(tmp_path))
                if d.startswith("tmp.")]


def test_save_async_surfaces_background_error(tmp_path):
    """A background writer death is not swallowed: wait() re-raises it,
    the previous checkpoint stays intact, and the checkpointer keeps
    working afterwards."""
    ck = TC.Checkpointer(str(tmp_path), keep=3)
    tree = _tree()
    ck.save(1, tree)
    TI.install_checkpoint_crash(at="bytes", offset=3)
    ck.save_async(2, tree)
    with pytest.raises(TI.InjectedCheckpointCrash):
        ck.wait()
    _assert_restorable(ck, 1, tree)
    ck.save_async(3, tree)                 # error state was cleared
    ck.wait()
    _assert_restorable(ck, 3, tree)


# ---------------------------------------------------------------------------
# Checkpointer: the on-disk format, crossing both ways
# ---------------------------------------------------------------------------

BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}


def _jax_state():
    """Reduced tinyllama ``LM.init`` (bf16) and ``adamw_init``: bf16,
    fp32 and the int32 step, moments made non-zero."""
    cfg = dataclasses.replace(jax_get_reduced("tinyllama-1.1b"), **BF16)
    params, _ = JaxLM(cfg).init(jax.random.key(3))
    opt = jax_adamw_init(params)
    rng = np.random.default_rng(7)
    opt = {**opt, "step": jnp.asarray(5, jnp.int32),
           "mu": jax.tree.map(lambda a: jnp.asarray(
               rng.standard_normal(a.shape), jnp.float32), opt["mu"])}
    return {"params": params, "opt": opt}


def _port_template():
    cfg = dataclasses.replace(get_reduced("tinyllama-1.1b"), **BF16)
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return {"params": params, "opt": adamw_init(params)}


def _as_bytes(t):
    t = t.contiguous()
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16
            else t).numpy().tobytes()


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    state = _jax_state()
    JC.Checkpointer(str(tmp_path)).save(4, state, extra={"step": 4})
    restored, extra = TC.Checkpointer(str(tmp_path)).restore(
        _port_template())
    assert extra == {"step": 4}
    want = jax.tree_util.tree_flatten_with_path(state)[0]
    got = TC._flatten(restored)
    assert [jax.tree_util.keystr(p) for p, _ in want] == [p for p, _ in got]
    dtypes = set()
    for (_, a), (path, t) in zip(want, got):
        a = np.asarray(a)
        assert str(a.dtype) == str(t.dtype).removeprefix("torch."), path
        assert a.shape == tuple(t.shape), path
        assert a.tobytes() == _as_bytes(t), path
        dtypes.add(str(a.dtype))
    assert dtypes == {"bfloat16", "float32", "int32"}


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path):
    """The port writes a tree that came from a JAX checkpoint; the JAX
    ``Checkpointer`` reads back every leaf bitwise, and both packages'
    manifests agree on paths, files, shapes and dtypes."""
    state = _jax_state()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    JC.Checkpointer(str(jdir)).save(4, state)
    tree, _ = TC.Checkpointer(str(jdir)).restore(_port_template())
    TC.Checkpointer(str(tdir)).save(4, tree, extra={"step": 4})
    back, extra = JC.Checkpointer(str(tdir)).restore(
        jax.tree.map(jnp.zeros_like, state))
    assert extra == {"step": 4}
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()

    def manifest(d):
        with open(d / "step_00000004" / "manifest.json") as f:
            return json.load(f)
    mj, mt = manifest(jdir), manifest(tdir)
    assert mj["paths"] == mt["paths"]
    assert mj["leaves"] == mt["leaves"]
    for m in mt["leaves"]:
        name = m["file"]
        assert (jdir / "step_00000004" / name).read_bytes() == \
            (tdir / "step_00000004" / name).read_bytes()


# ---------------------------------------------------------------------------
# decisions: plan_mesh, simulate_failures, HealthMonitor, FaultInjector
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 512), tpd=st.sampled_from([1, 4, 8, 16]),
       gb=st.sampled_from([8, 64, 128, 256]),
       max_prb=st.sampled_from([0, 2, 4, 16]),
       pp=st.sampled_from([1, 2, 4, 8, 16]), min_pp=st.sampled_from([0, 1, 2]),
       prefer_tp=st.sampled_from([0, 2, 4]),
       failed=st.lists(st.integers(0, 511), max_size=6))
def test_plan_mesh_decides_as_reference(n, tpd, gb, max_prb, pp, min_pp,
                                        prefer_tp, failed):
    kw = dict(tp_divides=tpd, global_batch=gb, max_per_replica_batch=max_prb,
              pp=pp, min_pp=min(min_pp, pp))

    def same(a, b):
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    same(TE.plan_mesh(n, TE.MeshRequirements(**kw), prefer_tp=prefer_tp),
         JE.plan_mesh(n, JE.MeshRequirements(**kw), prefer_tp=prefer_tp))
    failed = [f for f in failed if f < n]
    same(TE.simulate_failures(n, failed, TE.MeshRequirements(**kw)),
         JE.simulate_failures(n, failed, JE.MeshRequirements(**kw)))
    assert TE._grad_accum(gb, max_prb) == JE._grad_accum(gb, max_prb)


@pytest.mark.parametrize("seed", range(6))
def test_health_monitor_decides_as_reference(seed):
    """Random step times with slow stretches: every action, the slow
    streak and the median equal the reference's."""
    rng = np.random.default_rng(seed)
    kw = dict(straggler_factor=float(rng.choice([1.5, 2.0, 3.0])),
              straggler_patience=int(rng.integers(2, 5)),
              window=int(rng.choice([5, 8, 50])))
    t, j = TH.HealthMonitor(**kw), JH.HealthMonitor(**kw)
    times = rng.lognormal(0.0, 0.2, 300)
    for start in rng.integers(0, 300, 20):       # slow stretches
        times[start:start + rng.integers(1, 9)] *= rng.uniform(1.0, 12.0)
    acts = []
    for x in times:
        a, b = t.record_step(float(x)), j.record_step(float(x))
        assert a.value == b.value
        assert t._slow_streak == j._slow_streak
        acts.append(a.value)
    assert t.median_step == j.median_step
    assert {"continue", "checkpoint_now", "restart"} <= set(acts)


def _faults(mod):
    """One fault list of every kind, built from ``mod``'s classes."""
    return [mod.DeviceLoss(step=3, device=2), mod.DeviceLoss(step=3, device=0),
            mod.HungCollective(step=5, device=1, hang_s=30.0),
            mod.HungCollective(step=6, device=3, hang_s=700.0),
            mod.Straggler(step=8, n_steps=2, factor=4.0),
            mod.DeviceJoin(step=9, device=2), mod.DeviceJoin(step=9, device=0),
            mod.CheckpointCrash(step=4, at="bytes", offset=5),
            mod.TickDeviceLoss(tick=2, device=1),
            mod.SlotCorruption(tick=4, slot=3),
            mod.HungTick(tick=6, device=0, hang_s=900.0),
            mod.HungTick(tick=7, hang_s=1.0),
            mod.StragglerTicks(tick=9, n_ticks=2, factor=3.0)]


def _drive(mod, health):
    """Every seam of one injector over 12 steps and 12 ticks; returns
    what each call gave (values, or the raise's fields) and the events."""
    inj = mod.FaultInjector(_faults(mod))
    wd = health.Watchdog(600.0, clock=inj.clock)
    out = []

    def call(name, fn, *a):
        try:
            out.append((name, fn(*a)))
        except mod.DeviceLossError as e:
            out.append((name, "raise", e.device, e.kind, e.step))
    for s in range(12):
        call("yield", inj.should_yield, s)
        call("rejoined", inj.take_rejoined)
        call("start", inj.on_step_start, s)
        call("crash", inj.arm_checkpoint_crash, s)
        wd.arm()
        call("end", inj.on_step_end, s, wd)
        wd.disarm()
        call("time", inj.step_time, s, 0.5)
        call("clock", inj.clock)
    for k in range(12):
        call("tick_start", inj.on_tick_start, k)
        wd.arm()
        call("tick_end", inj.on_tick_end, k, wd if k != 7 else None)
        wd.disarm()
        call("slot", inj.take_slot_corruption, k)
        call("tick_time", inj.tick_time, k, 0.25)
    events = [(type(e["fault"]).__name__, dataclasses.asdict(e["fault"]),
               {k: v for k, v in e.items() if k != "fault"})
              for e in inj.events]
    return out, events, sorted(inj._fired)


def test_fault_injector_decides_as_reference(monkeypatch):
    """The same fault list through both injectors: every return, every
    raise (device, kind, step), the fake clock and the event log are
    equal, over steps and over ticks.  The checkpoint crash each arms is
    left installed on its package's seams; monkeypatch puts both back."""
    for mod in (JC, TC):
        monkeypatch.setattr(mod, "_write_file", mod._write_file)
        monkeypatch.setattr(mod, "_rename", mod._rename)
    got = _drive(TI, TH)
    want = _drive(JI, JH)
    assert got == want
    # the crash was armed on each package's own seam
    assert TC._write_file.__name__ == JC._write_file.__name__ == "bomb_write"
    # every one-shot kind fired (stragglers only inflate times)
    kinds = {e[0] for e in got[1]}
    assert kinds == {type(f).__name__ for f in _faults(TI)} - {
        "Straggler", "StragglerTicks"}
    assert len(got[2]) == len(_faults(TI))


# ---------------------------------------------------------------------------
# token shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_token_shards_cross_read(writer, tmp_path):
    """Shards written by either package: the files are byte-identical,
    and both readers give the same batches, state, dp stripes and
    mid-epoch resume (into either reader), across an epoch boundary."""
    kw = dict(vocab=500, seq_len=16, num_shards=3, per_shard=7, seed=4)
    paths = (jax_write_shards if writer == "jax" else
             write_synthetic_shards)(str(tmp_path / writer), **kw)
    other = (write_synthetic_shards if writer == "jax" else
             jax_write_shards)(str(tmp_path / "other"), **kw)
    for p, q in zip(paths, other):
        assert open(p, "rb").read() == open(q, "rb").read()
    for rank in (0, 1, 2):
        t = TokenShardDataset(paths, dp_rank=rank, dp_size=3, seed=9)
        j = JaxShards(paths, dp_rank=rank, dp_size=3, seed=9)
        assert len(t) == len(j)
        for n in (3, 5, 4, 6):              # 18 rows: past one epoch
            np.testing.assert_array_equal(t.next_batch(n), j.next_batch(n))
            assert t.state() == j.state()
    t = TokenShardDataset(paths, seed=2)
    t.next_batch(5)
    st_ = t.state()
    want = t.next_batch(9)
    for cls in (TokenShardDataset, JaxShards):
        d = cls(paths, seed=0)
        d.load_state(st_)
        np.testing.assert_array_equal(d.next_batch(9), want)


def test_shard_writer_uint32(tmp_path):
    """A uint32 shard from the port's writer reads alike in both readers."""
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 2 ** 20, (6, 8))
    p = str(tmp_path / "s.toks")
    w = ShardWriter(p, 8, dtype=np.uint32)
    for r in rows:
        w.add(r)
    w.close()
    t, j = TokenShardDataset([p], seed=1), JaxShards([p], seed=1)
    np.testing.assert_array_equal(t.next_batch(6), j.next_batch(6))
    assert sorted(map(tuple, TokenShardDataset([p]).next_batch(6))) == \
        sorted(map(tuple, rows.astype(np.int32)))
