"""The encoder-decoder (reduced whisper-base) and the VLM (reduced
paligemma-3b) on a ``pp x dp x tp`` mesh, and K/V heads replicated over
tp, on the CPU: gloo ranks holding CPU tensors (the rank bodies are
``tests/helpers/torch_families.py``'s), fp32.

- (A) pp 2 x dp 2 x tp 2, eight ranks: the rank executor (chronos_zb,
  P=2, m=4, two sequences of 17 tokens a dp rank a microbatch; whisper
  at v=1 with its 64 frames, paligemma at v=2 with its 16 patches) from
  the JAX package's ``init_pipeline_params`` weights at ZeRO stages 1
  and 3: whisper (its encoder split over tp like the decoder, the
  cross-attention's encoder input entering through ``copy_to_tp``),
  whisper at an odd vocabulary (511: the table and the head whole on
  every tp rank), paligemma (its one K/V head replicated over the two tp
  ranks of each K/V group); then two steps of ``train_pipeline(mesh=)``
  of paligemma against the one-device run, the replicas checked after
  each (the K/V groups' copies too).
- (B) pp 1 x dp 1 x tp 4, four ranks: paligemma (the K/V head on all
  four ranks) and tinyllama (8 query heads, 2 K/V heads: each over two
  ranks) at ZeRO stages 1 and 3; then the same processes regrouped as
  pp 1 x dp 2 x tp 2: ``train()``'s step (``step.grads``) of whisper and
  paligemma at stages 1 and 3, and one ``train()`` step of each with
  its replicas checked and its bytes counted.

The oracle is ``jax.grad`` of the JAX ``LM.loss`` (its batch with
``frame_embeds`` / ``patch_embeds``) on the global batch, summed over
the microbatches (never the JAX pipelined executor).  Tolerances:
``GRAD_TOL`` 1e-5 absolute for every gradient leaf and the loss
(``tests/test_torch_mesh.py``'s); stage 3 against stage 1 ``ZERO3_REL``
2e-5 relative to each leaf's largest element; the mesh's training
against the one-device run ``REL`` 1e-5 relative; the bytes handed to
collectives by axis equal to ``collective_stats`` and
``train_collective_stats`` exactly.  One spawn a layout, each under its
own timeout (``SPAWN_TIMEOUT``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_reduced as jax_get_reduced
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.models import LM as JaxLM
from repro_torch.core.pipeline_runtime import unstage_params
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn
from repro_torch.launch.train import train_pipeline
from repro_torch.tree import tree_leaves, tree_map
from helpers import torch_families as Fam
from helpers import torch_mesh as H
from helpers import torch_zero as Z
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPAWN_TIMEOUT = 240          # seconds, each spawn of ranks
GRAD_TOL = 1e-5
ZERO3_REL = 2e-5
REL = 1e-5
STAGES = (1, 3)
SHAPES = {"A": {"pp": 2, "data": 2, "model": 2},
          "B": {"pp": 1, "data": 1, "model": 4}}
SHAPE_C = {"pp": 1, "data": 2, "model": 2}
# name -> (layout, arch, fields replaced in both packages' reduced
# configs, the case's keywords)
CASES = {
    "whisper": ("A", "whisper-base", {}, dict(v=1)),
    "whisper-511": ("A", "whisper-base", {"vocab_size": 511}, dict(v=1)),
    "paligemma": ("A", "paligemma-3b", {}, {}),
    "paligemma-tp4": ("B", "paligemma-3b", {}, dict(dp=1, P=1)),
    "tinyllama-tp4": ("B", "tinyllama-1.1b", {}, dict(dp=1, P=1)),
}
STAGE3 = ("whisper", "paligemma", "paligemma-tp4", "tinyllama-tp4")
TRAIN_ARCHS = ("whisper-base", "paligemma-3b")
STEPS = 2                    # train_pipeline(mesh=) of paligemma on (A)


def _jax_cfg(name):
    _, arch, over, _ = CASES[name]
    return dataclasses.replace(jax_get_reduced(arch), **over)


@functools.lru_cache(maxsize=None)
def _case(name):
    """The case on the JAX package's ``init_pipeline_params`` weights."""
    _, arch, over, kw = CASES[name]
    jcfg = _jax_cfg(name)
    params, _ = jax_init_pipeline_params(
        jax.random.key(0), jcfg,
        JaxStageLayout.build(jcfg, kw.get("P", 2), kw.get("v", 2)))
    return H.case(arch, params=jax.tree.map(np.asarray, params),
                  cfg=over or None, **kw)


def _names(layout):
    return [n for n, c in CASES.items() if c[0] == layout]


def _pipe_tc(arch="paligemma-3b", **plan):
    """``train_pipeline`` of reduced ``arch``: chronos_zb P=2 v=2, m=4,
    two sequences of 17 tokens a dp rank a microbatch."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import (OptimizerConfig, ParallelPlan,
                                          ShapeConfig, TrainConfig)
    return TrainConfig(
        model=get_reduced(arch), shape=ShapeConfig("t", 17, 16, "train"),
        plan=ParallelPlan(**{**dict(schedule="chronos_zb", num_chunks=2,
                                    microbatch_size=2, num_microbatches=4,
                                    kernels="fused"), **plan}),
        optimizer=OptimizerConfig(warmup_steps=1, total_steps=STEPS,
                                  lr=1e-3),
        log_every=1)


# train() on (1, 2, 2): the JAX LM.init weights of each reduced model and
# a global batch of m=2 microbatches of two 32-token sequences (one a dp
# rank), with the config's patch or frame embeddings
TRAIN_M = 2


@functools.lru_cache(maxsize=None)
def _train_inputs(arch):
    from repro_torch.configs import get_reduced
    jcfg = jax_get_reduced(arch)
    jp, _ = JaxLM(jcfg).init(jax.random.key(Z.SEED))
    cfg = get_reduced(arch)
    rng = np.random.default_rng(6)
    lead = (TRAIN_M, SHAPE_C["data"])
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    lead + (Z.TRAIN_SEQ,)).astype(np.int64)}
    if cfg.vision is not None:
        batch["patch_embeds"] = rng.standard_normal(
            lead + (cfg.vision.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.encdec is not None:
        batch["frame_embeds"] = rng.standard_normal(
            lead + (cfg.encdec.num_frames, cfg.d_model)).astype(np.float32)
    return cfg, jax.tree.map(np.asarray, jp), batch


def _by_name(outs, key, items):
    return {item: [o[key][i] for o in outs] for i, item in enumerate(items)}


@pytest.fixture(scope="module")
def mesh222():
    runs = [(n, z) for n in _names("A") for z in STAGES]
    outs = spawn(8, Fam.encdec_vlm_suite,
                 args=([(_case(n), z) for n, z in runs],
                       [(_pipe_tc(), 2, {"overlap": True, "steps": STEPS,
                                         "log": H.quiet})]),
                 shape=(2, 2, 2), device="cpu", timeout_s=SPAWN_TIMEOUT)
    return {"grads": _by_name(outs, "grads", runs),
            "train": [o["train"][0] for o in outs]}


@pytest.fixture(scope="module")
def mesh114():
    runs = [(n, z) for n in _names("B") for z in STAGES]
    grads = [(a, z) for a in TRAIN_ARCHS for z in STAGES]
    single = ((1, 2, 2),
              [(_train_inputs(a)[0], z, _train_inputs(a)[1],
                _train_inputs(a)[2]) for a, z in grads],
              [(Z.train_config(1, a), _train_inputs(a)[1])
               for a in TRAIN_ARCHS])
    outs = spawn(4, Fam.encdec_vlm_suite,
                 args=([(_case(n), z) for n, z in runs], [], single),
                 shape=(1, 1, 4), device="cpu", timeout_s=SPAWN_TIMEOUT)
    return {"grads": _by_name(outs, "grads", runs),
            "single_grads": _by_name(outs, "single_grads", grads),
            "single_train": _by_name(outs, "single_train", TRAIN_ARCHS)}


def _grads_of(name, mesh222, mesh114, zero_stage):
    layout = CASES[name][0]
    return (mesh222 if layout == "A" else mesh114)["grads"][name,
                                                             zero_stage]


_JAX_VG = {}


def _jax_value_and_grad(key, jcfg, params, batch):
    """``jax.grad`` of the JAX ``LM.loss`` summed over the microbatches of
    the global numpy ``batch`` (``[m, B, ...]``; one compiled
    microbatch, called for each)."""
    if key not in _JAX_VG:
        lm = JaxLM(jcfg)
        _JAX_VG[key] = jax.jit(jax.value_and_grad(
            lambda p, b: lm.loss(p, b)[0]))
    outs = [_JAX_VG[key](params, {k: jnp.asarray(
        v[i].astype(np.int32) if k == "tokens" else v[i])
        for k, v in batch.items()}) for i in range(len(batch["tokens"]))]
    return (sum(o[0] for o in outs),
            jax.tree.map(lambda *g: sum(g), *[o[1] for o in outs]))


def _rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-12))


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_grads_match_jax_autodiff(name, mesh222, mesh114):
    """The gradients the ranks hold (their pp column, tp shard; a
    replicated K/V head from its group's first rank), joined, and the
    loss against ``jax.grad`` of the JAX ``LM.loss`` over the global
    batch on the JAX weights, every leaf within ``GRAD_TOL``: whisper's
    encoder and cross-attention leaves among them, paligemma's with its
    patch prefix; the bridge cut every rank's tree as its shard says,
    and every rank of a K/V group holds the same K/V gradient."""
    c = _case(name)
    spec = H.spec_of(c)
    shape = SHAPES[CASES[name][0]]
    ranks = _grads_of(name, mesh222, mesh114, 1)
    assert all(r["bridge_equal"] for r in ranks)
    assert len({float(r["loss"]) for r in ranks}) == 1
    shard = Z.rank_shard(spec, shape, {"pp": 0, "data": 0, "model": 0}, 1)
    rep = shard.kv_rep
    assert any(shard.kv) == (name in ("paligemma", "paligemma-tp4",
                                      "tinyllama-tp4"))
    for r in ranks:
        t = r["coords"]["model"]
        twin = next(o for o in ranks if o["coords"]["model"] == t - t % rep
                    and o["coords"]["pp"] == r["coords"]["pp"]
                    and o["coords"]["data"] == r["coords"]["data"])
        for g, h, kv in zip(tree_leaves(r["g"]), tree_leaves(twin["g"]),
                            shard.kv):
            assert not kv or bool((g == h).all())
    got = H.gather(spec, shape, ranks)
    params = H.full_params(c, spec)
    loss, ref = _jax_value_and_grad(
        name, _jax_cfg(name), jax.tree.map(jnp.asarray, tree_map(
            lambda a: a.numpy().copy(), unstage_params(params, spec.layout))),
        {"tokens": c["tokens"], **c["embeds"]})
    ours = tree_leaves(unstage_params(got, spec.layout))
    theirs = jax.tree.leaves(ref)
    assert len(ours) == len(theirs)
    errs = [float(np.abs(a.numpy() - np.asarray(b)).max())
            for a, b in zip(ours, theirs)]
    e_loss = abs(float(ranks[0]["loss"]) - float(loss) / spec.table.m)
    print(f"{name} {tuple(shape.values())} vs jax.grad: max |d grad| "
          f"{max(errs):.3e}, |d loss| {e_loss:.3e} (K/V over {rep} ranks)")
    assert max(errs) <= GRAD_TOL and e_loss <= GRAD_TOL


@pytest.mark.parametrize("name", STAGE3)
def test_mesh_stage3_matches_stage1(name, mesh222, mesh114):
    """ZeRO stage 3 (each rank holding its dp slice of every block leaf
    the reference keeps fsdp on, the replicated K/V heads' too; at dp 1
    nothing is sliced) against stage 1 on the same weights and batch:
    every joined gradient leaf within ``ZERO3_REL``, the loss within it
    on every rank."""
    spec = H.spec_of(_case(name))
    shape = SHAPES[CASES[name][0]]
    one = Z.join_pipeline(spec, shape,
                          _grads_of(name, mesh222, mesh114, 1), 1)
    three = Z.join_pipeline(spec, shape,
                            _grads_of(name, mesh222, mesh114, 3), 3)
    errs = [_rel(a.float(), b) for a, b in zip(tree_leaves(three),
                                               tree_leaves(one))]
    print(f"{name} stage 3 vs stage 1: max rel {max(errs):.3e}")
    assert max(errs) <= ZERO3_REL
    l1 = float(_grads_of(name, mesh222, mesh114, 1)[0]["loss"])
    for r in _grads_of(name, mesh222, mesh114, 3):
        assert abs(float(r["loss"]) - l1) <= ZERO3_REL * abs(l1)


@pytest.mark.parametrize("name,zero_stage",
                         [(n, z) for n in CASES for z in STAGES])
def test_mesh_bytes_are_collective_stats(name, zero_stage, mesh222,
                                         mesh114):
    """The bytes the ranks hand to collectives in one gradient pass, by
    axis, equal ``collective_stats``' count: whisper's encoder sums where
    an op runs it and its cross-attentions' (the encoder input's gradient
    where the payload needs one), and the replicated K/V heads' gradient
    sums over their K/V groups (``all-reduce-kv``, under "model")."""
    spec = H.spec_of(_case(name))
    shape = SHAPES[CASES[name][0]]
    ranks = _grads_of(name, mesh222, mesh114, zero_stage)
    stats = dryrun.collective_stats(spec, shape["data"], shape["model"],
                                    update=False, zero_stage=zero_stage)
    for ax in ("pp", "data", "model"):
        assert sum(r["bytes"][ax] for r in ranks) == stats.by_axis[ax], ax
    kv = Z.rank_shard(spec, shape, {"pp": 0, "data": 0, "model": 0},
                      zero_stage).kv
    assert ("all-reduce-kv" in stats.bytes_by_kind) == any(kv)


def test_mesh_training_keeps_kv_groups_equal(mesh222):
    """Two overlapped steps of ``train_pipeline(mesh=)`` of reduced
    paligemma on (2, 2, 2) against the one-device run on the same global
    batches: losses and gradient norms within ``REL``; after every step
    the replicas bitwise equal (every weight over dp, the tp-replicated
    leaves over tp, the shared leaves over pp, and each K/V head's copies
    within its K/V group, weights and fp32 masters); each step's bytes by
    axis ``collective_stats``'."""
    tc = _pipe_tc()
    one = train_pipeline(dataclasses.replace(tc, plan=dataclasses.replace(
        tc.plan, microbatch_size=4)), P=2, device="cpu", log=H.quiet)
    ranks = mesh222["train"]
    spec = H.spec_of(H.case("paligemma-3b"))
    coll = dryrun.collective_stats(spec, 2, 2, update=True)
    assert coll.bytes_by_kind["all-reduce-kv"] > 0
    for r in ranks:
        assert r["steps"] == STEPS
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=REL,
                                   atol=0)
        np.testing.assert_allclose(r["grad_norms"], one["grad_norms"],
                                   rtol=REL, atol=0)
        assert r["replicas_equal"] == [True] * STEPS
        assert all(set(c) == {"pp", "data", "model", "kv"}
                   for c in r["replica_checks"])
    for step in range(STEPS):
        for ax in ("pp", "data", "model"):
            assert sum(r["exchange"]["axis_bytes"][step][ax]
                       for r in ranks) == coll.by_axis[ax], (step, ax)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_grads_match_jax_autodiff(arch, mesh114):
    """``train()``'s step on (1, 2, 2) at ZeRO stage 1 (``step.grads``:
    the fp32 sums of the rank's state slices, the dp rows of each global
    microbatch, the replicated K/V head summed over its group) joined
    from the ranks, against ``jax.grad`` of the JAX ``LM.loss`` summed
    over the global microbatches, every leaf within ``GRAD_TOL``; the
    loss sums too; stage 3 against stage 1 within ``ZERO3_REL``."""
    cfg, np_params, batch = _train_inputs(arch)
    tree = Z.lm_tree(np_params)
    ranks = mesh114["single_grads"][arch, 1]
    got = Z.join_lm(ranks, "g", SHAPE_C, tree)
    loss, ref = _jax_value_and_grad(("train", arch), jax_get_reduced(arch),
                                    jax.tree.map(jnp.asarray, np_params),
                                    batch)
    errs = [float(np.abs(a.numpy() - np.asarray(b)).max())
            for a, b in zip(tree_leaves(got), jax.tree.leaves(ref))]
    assert len(errs) == len(jax.tree.leaves(ref))
    e_loss = max(abs(r["lsum"] - float(loss)) for r in ranks)
    three = Z.join_lm(mesh114["single_grads"][arch, 3], "g", SHAPE_C, tree)
    e3 = max(_rel(a, b) for a, b in zip(tree_leaves(three),
                                         tree_leaves(got)))
    print(f"train() {arch} (1,2,2) vs jax.grad: max |d grad| "
          f"{max(errs):.3e}, |d loss sum| {e_loss:.3e}; stage 3 vs 1 "
          f"{e3:.3e}")
    assert any(ranks[0]["kv"]) == (arch == "paligemma-3b")
    assert max(errs) <= GRAD_TOL and e_loss <= GRAD_TOL
    assert e3 <= ZERO3_REL


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_on_the_mesh_replicas_and_bytes(arch, mesh114):
    """One step of ``train(tc, mesh=)`` of each on (1, 2, 2) at stage 1
    from the JAX weights: finite losses equal on every rank; the replicas
    bitwise equal after the step (paligemma's K/V copies within each
    group too); the step's bytes by axis ``train_collective_stats``'
    (whisper's encoder and cross-attention sums, paligemma's K/V sums)."""
    ranks = mesh114["single_train"][arch]
    losses = ranks[0]["losses"]
    assert all(np.isfinite(losses))
    assert all(r["losses"] == losses for r in ranks)
    for r in ranks:
        assert all(all(c.values()) for c in r["replica_checks"])
        assert ("kv" in r["replica_checks"][0]) == (arch == "paligemma-3b")
    tc = Z.train_config(1, arch)
    stats = dryrun.train_collective_stats(
        tc.model, m=TRAIN_M, mbB=1, seq_len=Z.TRAIN_SEQ, dp=2, tp=2,
        zero_stage=1)
    got = {ax: sum(r["axis_bytes"][0][ax] for r in ranks)
           for ax in ("pp", "data", "model")}
    assert got == stats.by_axis
    assert (stats.bytes_by_kind["all-reduce-kv"] > 0) == \
        (arch == "paligemma-3b")


def test_kv_groups_lie_on_tp_lines():
    """``kv_groups``: for every span strictly between 1 and tp that
    divides tp, the runs of ``span`` consecutive tp coordinates of every
    tp line (rank ``(p * dp + d) * tp + t``), in one order; none at tp 2
    (a span of tp is the line's own group)."""
    from repro_torch.launch.mesh import kv_groups, mesh_groups
    assert kv_groups(2, 2, 2) == {} and kv_groups(4, 2, 1) == {}
    g = kv_groups(2, 1, 4)
    assert g == {2: [[0, 1], [2, 3], [4, 5], [6, 7]]}
    assert sorted(kv_groups(1, 16, 16)) == [2, 4, 8]
    lines = mesh_groups(2, 2, 8)["model"]
    for span, groups in kv_groups(2, 2, 8).items():
        assert len(groups) == len(lines) * 8 // span
        for grp in groups:
            line = next(ln for ln in lines if grp[0] in ln)
            i = line.index(grp[0])
            assert i % span == 0 and grp == line[i:i + span]
