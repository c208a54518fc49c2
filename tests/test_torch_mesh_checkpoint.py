"""Checkpoints written and restored by the ranks of a mesh, on the CPU:
eight gloo ranks holding CPU tensors, spawned once
(``tests/helpers/torch_mesh_offload.py`` holds the rank bodies).
Reduced tinyllama (4 layers, d 128, fp32), chronos_zb P=2 v=2, m=4, two
sequences of 17 tokens a dp rank a microbatch, on pp 2 x dp 2 x tp 2 at
ZeRO stages 1 and 3 and with the deepest chunk offloaded; the same
processes regrouped as pp 2 x dp 1 x tp 4 (the reference's ``reshard``
onto another mesh) and as pp 1 x dp 4 x tp 2 (``train(tc, mesh=)``).

- the checkpoint of the ranks is the reference's format: the JAX
  package's own ``Checkpointer.restore`` reads it, its leaves bitwise the
  ranks' joined state, its manifest the one-device port's for the same
  plan;
- a resume on the same mesh is bitwise the uninterrupted run (under
  offload, the first resumed step's loss: the host momenta are not
  checkpointed and the host masters restart from the bf16 weights, as in
  the reference);
- a restore onto pp 2 x dp 1 x tp 4 trains on within the mesh tests'
  2e-5 relative of the uninterrupted run;
- a rank reads only its part of each leaf file."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ft import Checkpointer as JaxCheckpointer
from repro_torch.configs import get_reduced
from repro_torch.configs.base import (OffloadConfig, OptimizerConfig,
                                      ParallelPlan, ShapeConfig, TrainConfig)
from repro_torch.core.pipeline_runtime import (RankShard,
                                               init_pipeline_params,
                                               make_pipeline_spec)
from repro_torch.ft import checkpoint as TC
from repro_torch.launch.mesh import MESH_RULES, spawn
from repro_torch.launch.steps import offload_kept
from repro_torch.launch.train import rank_parts, train_pipeline
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_map
from helpers import torch_mesh_offload as O
from helpers import torch_zero as Z
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPAWN_TIMEOUT = 300          # seconds, the one spawn
P, V, M, MBB, SEQ, DP = 2, 2, 4, 2, 17, 2
STEPS, CUT = 3, 2
REL = 2e-5                   # the mesh tests' relative bound


def _tc(zero_stage=1, offload=False, mbB=MBB):
    return TrainConfig(
        model=get_reduced("tinyllama-1.1b"),
        shape=ShapeConfig("t", SEQ, M * MBB * DP, "train"),
        plan=ParallelPlan(schedule="chronos_zb", num_chunks=V,
                          microbatch_size=mbB, num_microbatches=M,
                          kernels="fused", zero_stage=zero_stage,
                          offload=OffloadConfig(enabled=offload,
                                                num_offload_chunks=1)),
        optimizer=OptimizerConfig(warmup_steps=1, total_steps=STEPS,
                                  lr=1e-3),
        seed=5, log_every=100)


# (zero stage, offload)
PIPE = {"z1": (1, False), "z3": (3, False), "offload": (1, True)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_ckpt")
    dirs = {k: (str(root / f"{k}_resume"), str(root / f"{k}_cut"))
            for k in PIPE}
    pipe = [(_tc(*PIPE[k]), None, *dirs[k], STEPS, CUT) for k in PIPE]
    # the same global batch on dp 1: four sequences a dp rank
    reshard = (_tc(1, mbB=MBB * DP), dirs["z1"][1], STEPS)
    single = [(Z.train_config(1), None, str(root / "train_resume"), STEPS,
               CUT)]
    outs = spawn(8, O.checkpoint_suite, args=(pipe, reshard, single),
                 shape=(2, 2, 2), device="cpu", timeout_s=SPAWN_TIMEOUT)
    return {"dirs": dirs, "root": root,
            "pipe": {k: [o["pipe"][i] for o in outs]
                     for i, k in enumerate(PIPE)},
            "reshard": [o["reshard"] for o in outs],
            "single": [o["single"][0] for o in outs]}


def _spec():
    return make_pipeline_spec(get_reduced("tinyllama-1.1b"), P=P, v=V, m=M,
                              microbatch=MBB, seq_len=SEQ,
                              schedule="chronos_zb")


def _global_template(offload):
    """The one-device tree of a checkpoint (``params`` and the optimizer
    state, under offload the kept part's) on the meta device."""
    meta = init_pipeline_params(None, get_reduced("tinyllama-1.1b"),
                                _spec().layout, "meta")
    kept = offload_kept(meta, _tc(offload=True).plan)[0] if offload \
        else meta
    return {"params": meta, "opt": adamw_init(kept)}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("case", list(PIPE))
def test_the_ranks_checkpoint_restores_in_jax_bitwise(case, ranks):
    """The JAX package's ``Checkpointer.restore`` reads the checkpoint the
    eight ranks wrote after ``CUT`` steps: every leaf (weights, mu, nu,
    the fp32 masters) bitwise the ranks' joined state, at the global
    shapes; the optimizer's step is ``CUT``."""
    _, cutdir = ranks["dirs"][case]
    rs = ranks["pipe"][case]
    tmpl = _global_template(PIPE[case][1])
    jt = tree_map(lambda a: jnp.zeros(a.shape, {
        torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.int32: jnp.int32}[a.dtype]), tmpl)
    back, extra = JaxCheckpointer(cutdir).restore(jt, step=CUT)
    assert extra["step"] == CUT
    assert extra["layout"] == {"P": P, "v": V, "schedule": "chronos_zb",
                               "placement": "interleaved"}
    want = {"params": O.join([r["cut_state"] for r in rs], "params"),
            **{k: O.join([r["cut_state"] for r in rs], k)
               for k in ("mu", "nu", "master")}}
    for key, got in (("params", back["params"]),
                     ("mu", back["opt"]["mu"]), ("nu", back["opt"]["nu"]),
                     ("master", back["opt"]["master"])):
        leaves = jax.tree.leaves(got)
        assert len(leaves) == len(want[key])
        for a, b in zip(leaves, want[key]):
            a = np.asarray(a)
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), key
    assert int(np.asarray(back["opt"]["step"])) == CUT


@pytest.mark.parametrize("case", ["z1", "offload"])
def test_the_manifest_is_the_one_device_ports(case, ranks, tmp_path):
    """The ranks' manifest (paths, files, global shapes, dtypes, null
    specs, the layout in ``extra``) equals the one written by the
    one-device ``train_pipeline`` of the same plan (its microbatch the
    global one)."""
    zero, offload = PIPE[case]
    tc = dataclasses.replace(_tc(zero, offload, mbB=MBB * DP),
                             checkpoint_dir=str(tmp_path),
                             checkpoint_every=1)
    train_pipeline(tc, P=P, device="cpu", steps=CUT, log=O.quiet)
    one = _manifest(str(tmp_path), CUT)
    mesh = _manifest(ranks["dirs"][case][1], CUT)
    assert mesh["paths"] == one["paths"]
    assert mesh["leaves"] == one["leaves"]
    assert mesh["extra"]["layout"] == one["extra"]["layout"]
    assert mesh["extra"]["step"] == one["extra"]["step"] == CUT


@pytest.mark.parametrize("case", ["z1", "z3"])
def test_a_same_mesh_resume_is_bitwise(case, ranks):
    """``train_pipeline(mesh=)`` cut after ``CUT`` steps and resumed from
    its checkpoint: the resumed losses and every final leaf (weights, mu,
    nu, masters) bitwise the uninterrupted run's."""
    rs = ranks["pipe"][case]
    for r in rs:
        assert r["start"] == CUT
        assert r["first"] == r["full"][:CUT]
        assert r["resumed"] == r["full"][CUT:]
    for key in ("params", "mu", "nu", "master"):
        for a, b in zip(O.join([r["resumed_state"] for r in rs], key),
                        O.join([r["full_state"] for r in rs], key)):
            assert a.tobytes() == b.tobytes(), key


def test_an_offload_resume_is_bitwise_at_its_first_step(ranks):
    """Under offload the resumed run's first loss is the uninterrupted
    run's bitwise (its weights are the checkpoint's); later steps restart
    the host momenta, as the reference."""
    for r in ranks["pipe"]["offload"]:
        assert r["start"] == CUT
        assert r["resumed"][0] == r["full"][CUT]


def test_train_on_the_mesh_resumes_bitwise(ranks):
    """``train(tc, mesh=)`` on pp 1 x dp 4 x tp 2, cut after ``CUT`` steps
    and resumed from its checkpoint: the losses bitwise the uninterrupted
    run's."""
    for r in ranks["single"]:
        assert r["start"] == CUT
        assert r["first"] + r["resumed"] == r["full"]


def test_a_restore_onto_another_mesh_trains_on(ranks):
    """The (2, 2, 2) checkpoint after ``CUT`` steps restored onto the same
    processes regrouped as pp 2 x dp 1 x tp 4 (the reference's
    ``reshard``: the same read, cut for the new mesh), then trained to
    ``STEPS``: losses within ``REL`` of the uninterrupted (2, 2, 2) run,
    equal on every rank."""
    full = ranks["pipe"]["z1"][0]["full"]
    rs = ranks["reshard"]
    assert all(r["start"] == CUT and r["losses"] == rs[0]["losses"]
               for r in rs)
    got = rs[0]["losses"]
    assert len(got) == STEPS - CUT
    for a, b in zip(got, full[CUT:]):
        assert abs(a - b) <= REL * abs(b), (got, full)


@pytest.mark.parametrize("coords", [{"pp": 1, "data": 1, "model": 1},
                                    {"pp": 0, "data": 0, "model": 1}])
def test_a_rank_reads_only_its_part(coords, ranks, monkeypatch):
    """A rank's restore reads only its parts of the leaf files: every read
    (``_read_part``, a memory map cut at the part) covers exactly the
    rank's tensor, fewer elements than the whole leaf wherever the rank
    holds a part of it, and lands the ranks' saved values."""
    _, cutdir = ranks["dirs"]["z1"]
    spec = _spec()
    shape = {"pp": P, "data": DP, "model": 2}
    shard = RankShard(spec.cfg, spec.layout, shape, MESH_RULES, coords, 1)
    meta = init_pipeline_params(None, spec.cfg, spec.layout, "meta")
    tree = shard.cut(tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype),
                              meta), coords["pp"])
    opt = adamw_init(shard.zero_views(tree))
    parts = rank_parts(tree, opt, shard, pp=coords["pp"], first=False)
    reads = {}
    real = TC._read_part

    def spy(path, dtype, shape_, index):
        a = real(path, dtype, shape_, index)
        reads[path] = (int(np.prod(shape_)), a.size)
        return a
    monkeypatch.setattr(TC, "_read_part", spy)
    ck = TC.MeshCheckpointer(cutdir, rank=5, size=8)
    ck.restore_into({"params": tree, "opt": opt}, step=CUT, parts=parts)
    local = tree_leaves({"params": tree, "opt": opt})
    assert len(reads) == len(local)
    assert sorted(n for _, n in reads.values()) == sorted(
        a.numel() for a in local)
    cut = [n for whole, n in reads.values() if n < whole]
    assert len(cut) > len(reads) // 2
    assert sum(n for _, n in reads.values()) < \
        sum(w for w, _ in reads.values()) / 2
    rec = ck.records[-1]
    assert rec["op"] == "restore" and rec["bytes"] == sum(
        a.numel() * a.element_size() for a in local)
    # the values the ranks saved, at this rank's parts
    rs = ranks["pipe"]["z1"]
    for got, part, want in zip(tree_leaves(tree),
                               tree_leaves(parts["params"]),
                               O.join([r["cut_state"] for r in rs],
                                      "params")):
        assert np.array_equal(got.numpy(), want[part.index])


def sorted_leaves(tree):
    """Leaves in the checkpoint's order (dict keys sorted)."""
    return [x for _, x in TC._flatten(tree)]


def test_rank_parts_cover_every_element_once():
    """Over the eight ranks of (2, 2, 2) at stages 1 and 3 and under
    offload, each element of every global leaf of the checkpoint has
    exactly one writer."""
    spec = _spec()
    shape = {"pp": P, "data": DP, "model": 2}
    for zero, offload in PIPE.values():
        tmpl = _global_template(offload)
        counts = [np.zeros(a.shape, np.int32)
                  for a in sorted_leaves(tmpl)]
        cut = V - 1
        for rank in range(8):
            co = dict(zip(("pp", "data", "model"),
                          (rank // 4, (rank // 2) % 2, rank % 2)))
            whole = RankShard(spec.cfg, spec.layout, shape, MESH_RULES, co,
                              zero)
            kept = RankShard(spec.cfg, spec.layout, shape, MESH_RULES, co,
                             zero, chunks=slice(0, cut)) if offload \
                else whole
            parts = rank_parts(tmpl["params"], tmpl["opt"], whole, kept,
                               pp=co["pp"], first=rank == 0)
            for c, part in zip(counts, sorted_leaves(parts)):
                if part.writes:
                    c[part.index] += 1
        assert all((c == 1).all() for c in counts), (zero, offload)


def test_offload_and_checkpoints_on_a_pipe_of_ranks(tmp_path):
    """On a pipe of two ranks alone (``spawn`` without a shape: a
    ``PipeMesh``, each rank its whole column): offload trains within
    1e-5 relative of the one-device offload run, and its checkpoint
    resumes with the first resumed step's loss bitwise the uninterrupted
    run's."""
    tc = _tc(offload=True)
    outs = spawn(2, O.pipe_resume, args=(tc, str(tmp_path / "pipe"), STEPS,
                                         CUT),
                 device="cpu", timeout_s=SPAWN_TIMEOUT)
    one = train_pipeline(tc, P=P, device="cpu", steps=STEPS, log=O.quiet,
                         data_source=O._source(tc))["losses"]
    for r in outs:
        assert r["full"] == outs[0]["full"] and r["start"] == CUT
        assert r["first"] == r["full"][:CUT]
        assert r["resumed"][0] == r["full"][CUT]
        assert r["offload"]["submits"] == STEPS
    np.testing.assert_allclose(outs[0]["full"], one, rtol=1e-5)
