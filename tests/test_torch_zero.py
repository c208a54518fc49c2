"""ZeRO stage 3 with the reference's fsdp block layout, and the
single-device ``train()`` under dp x tp, on the CPU: gloo ranks holding
CPU tensors (``tests/helpers/torch_zero.py`` holds the rank bodies).

- (A) ``train_pipeline`` / the rank executor on pp 2 x dp 2 x tp 2 at
  ``zero_stage`` 3 (reduced tinyllama, fp32, chronos_zb P=2 v=2 m=4, two
  sequences of 17 tokens a dp rank a microbatch): each rank holds its dp
  slice of every block leaf the reference keeps fsdp on, gathered by
  each F, B and W op.
- (B) ``train(tc, mesh=)`` on 1 x dp 2 x tp 2 at stages 1, 2 and 3 (the
  reference's ``make_train_step`` sharding), from the bridged JAX
  weights against the JAX ``train()``.

Tolerances: the gathered gradients against ``jax.grad`` of the JAX
``LM.loss`` ``GRAD_TOL`` 1e-5 absolute (``tests/test_torch_mesh.py``'s),
against the stage-1 run and the one-device executor ``REL`` 1e-5
relative to each leaf's largest element; ``train()`` against the JAX
``train()`` at ``tests/test_torch_train_single.py``'s bounds (loss
1e-5, mu 1e-6, weights 1e-6 with at most 1e-3 of the elements past it);
the bytes the ranks hand to collectives, by axis, equal to
``launch.dryrun.collective_stats(zero_stage=3)`` and
``train_collective_stats`` exactly.  Each mesh shape is spawned once,
under its own timeout (``SPAWN_TIMEOUT``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import base as JB
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.ft import Checkpointer as JaxCheckpointer
from repro.launch import steps as jax_steps
from repro.launch import train as jax_train_module
from repro.models import LM as JaxLM
from repro.models import sharding as jax_sharding
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.adamw import drop_fsdp as jax_drop_fsdp
from repro.optim.adamw import zero_state_specs as jax_zero_state_specs
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelPlan
from repro_torch.core.pipeline_runtime import unstage_params
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MESH_RULES, spawn
from repro_torch.launch.steps import check_zero_stage, lm_shard
from repro_torch.launch.train import train, train_pipeline
from repro_torch.models import LM
from repro_torch.models import sharding as S
from repro_torch.models.transformer import lm_specs
from repro_torch.optim.adamw import drop_fsdp, zero_state_specs
from repro_torch.tree import tree_leaves, tree_map
from helpers import torch_mesh as H
from helpers import torch_zero as Z
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPAWN_TIMEOUT = 240          # seconds, each spawn of ranks
GRAD_TOL = 1e-5
REL = 1e-5
LOSS_TOL, MU_TOL, W_TOL, W_FRAC = 1e-5, 1e-6, 1e-6, 1e-3
SHAPE = {"pp": 2, "data": 2, "model": 2}
SHAPE_B = {"pp": 1, "data": 2, "model": 2}
STEPS = 3
TRAIN_STAGES = (1, 2, 3)

def _jax_params():
    """The JAX package's ``init_pipeline_params`` weights (P=2, v=2), as
    numpy."""
    from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
    from repro.core.pipeline_runtime import \
        init_pipeline_params as jax_init_pipeline_params
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


def _tc(**plan):
    """``tests/test_torch_mesh.py``'s pipeline run: chronos_zb P=2 v=2,
    m=4, two sequences a dp rank a microbatch, 3 steps."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import (OptimizerConfig, ShapeConfig,
                                          TrainConfig)
    return TrainConfig(
        model=get_reduced("tinyllama-1.1b"),
        shape=ShapeConfig("t", 17, 16, "train"),
        plan=ParallelPlan(**{**dict(schedule="chronos_zb", num_chunks=2,
                                    microbatch_size=2, num_microbatches=4,
                                    kernels="fused"), **plan}),
        optimizer=OptimizerConfig(warmup_steps=1, total_steps=STEPS,
                                  lr=1e-3),
        log_every=1)


CASES = {"jax-weights": H.case(params=_jax_params()),
         "masked": H.case(mask=_mask())}
# (case, zero stage, watch what is held between ops)
GRAD_RUNS = [("jax-weights", 1, False), ("jax-weights", 3, True),
             ("masked", 3, False)]


def _rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-12))


def _spec_leaves(specs):
    """The reference's spec tree flattened in ``jax.tree.leaves`` order
    (a tuple or None is a leaf)."""
    return jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, tuple)
                           or s is None)


# ---------------------------------------------------------------------------
# specs and refusals (no processes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_lm_specs_are_the_reference(arch):
    """``lm_specs`` equals the reference's ``_specs_only`` for every
    config, and so do ``drop_fsdp`` of it and ``zero_state_specs`` of it
    at stages 0-3 (stage 2 equal to stage 1, as the reference does not
    tell them apart)."""
    ours = lm_specs(get_config(arch))
    ref = jax_steps._specs_only(jax_get_config(arch))
    assert S.spec_leaves(ours) == _spec_leaves(ref)
    assert S.spec_leaves(drop_fsdp(ours)) == _spec_leaves(jax_drop_fsdp(ref))
    for stage in (0, 1, 2, 3):
        assert S.spec_leaves(zero_state_specs(ours, stage)) == \
            _spec_leaves(jax_zero_state_specs(ref, stage))
    assert zero_state_specs(ours, 2) == zero_state_specs(ours, 1)
    assert len(S.spec_leaves(ours)) == len(tree_leaves(
        LM(get_config(arch), device="meta").init(None)))


class _Stub:
    def __init__(self, shape):
        self.shape = shape


def _canon(spec):
    return tuple((a,) if isinstance(a, str) else a for a in spec)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-7b",
                                  "mamba2-2.7b", "whisper-base"])
@pytest.mark.parametrize("zero_stage", [1, 3])
def test_train_shard_is_the_reference_layout(arch, zero_stage):
    """``lm_shard`` on a (1, 2, 2) layout: the parameters' physical
    specs are the reference's ``make_train_step`` ``p_shard`` specs
    (``drop_fsdp`` below stage 3, as they are at stage 3), the state's
    its ``o_shard`` specs at the stage (``max(stage, 1)``), each
    sanitized on the global shapes."""
    cfg = get_config(arch)
    shape = dict(SHAPE_B)
    sh = lm_shard(cfg, shape, MESH_RULES, {"pp": 0, "data": 0, "model": 0},
                  zero_stage)
    logical = jax_steps._specs_only(jax_get_config(arch))
    p_log = logical if zero_stage >= 3 else jax_drop_fsdp(logical)
    s_log = jax_zero_state_specs(logical, max(zero_stage, 1))
    env = jax_sharding.ShardEnv(_Stub(shape), MESH_RULES)
    shapes = [tuple(a.shape) for a in tree_leaves(
        LM(cfg, device="meta").init(None))]

    def phys(tree):
        return [_canon(jax_sharding.sanitize_spec(env.resolve(sp), s,
                                                  _Stub(shape)))
                for sp, s in zip(_spec_leaves(tree), shapes)]
    assert [_canon(sp) for sp in sh.param_specs] == phys(p_log)
    want_zero = [next((i for i, a in enumerate(sp) if a == ("data",)
                       or (isinstance(a, tuple) and "data" in a)), None)
                 for sp in phys(s_log)]
    assert sh.zero_dims == want_zero
    if zero_stage == 3:
        assert sh.sliced and all(k is None or k == z for k, z in
                                 zip(sh.fsdp_dims, sh.zero_dims))
    else:
        assert not sh.sliced


@pytest.mark.parametrize("zero_stage", [0, 1, 2, 3])
def test_rank_shard_keeps_fsdp_on_the_blocks_at_stage_3(zero_stage):
    """The pipeline's ``RankShard``: at stage 3 every block leaf whose
    reference spec carries fsdp is held as its dp slice (the
    reference's block layout, ``steps.py:403-413``), on the dimension its
    state is cut on; the shared leaves never; below stage 3 nothing is
    (and stages 1 and 2 hold the same)."""
    spec = H.spec_of(H.case())
    sh = Z.rank_shard(spec, SHAPE, {"pp": 1, "data": 1, "model": 0},
                      zero_stage)
    logical = spec_leaves_of(spec)
    for path, k, z, lg in zip(sh.paths, sh.fsdp_dims, sh.zero_dims,
                              logical):
        fsdp = any(a == "fsdp" for a in lg)
        assert (k is not None) == (zero_stage == 3 and path[0] == "blocks"
                                   and fsdp), path
        assert k is None or k == z
    assert any(z is not None for z in sh.zero_dims) == (zero_stage >= 1)
    if zero_stage == 2:
        one = Z.rank_shard(spec, SHAPE, {"pp": 1, "data": 1, "model": 0}, 1)
        assert one.zero_dims == sh.zero_dims and \
            one.param_specs == sh.param_specs


def spec_leaves_of(spec):
    from repro_torch.core.pipeline_runtime import pipeline_logical_specs
    return S.spec_leaves(pipeline_logical_specs(spec.cfg, spec.layout))


def test_zero_stages_2_and_3_are_accepted():
    """``check_zero_stage`` and the planner's ``parallel_plan`` take
    stages 0-3 and refuse another."""
    from repro_torch.configs import get_reduced
    from repro_torch.plan import (ExecutablePlan, PlannerQuery,
                                  enumerate_points)
    q = PlannerQuery(cfg=get_reduced("tinyllama-1.1b"), pp=2, tp=1,
                     hbm_bytes=1e12, microbatch=1, seq_len=17)
    ep = ExecutablePlan(q, enumerate_points(q)[0])
    for z in (0, 1, 2, 3):
        check_zero_stage(ParallelPlan(zero_stage=z))
        assert ep.parallel_plan(zero_stage=z).zero_stage == z
    for z in (-1, 4):
        with pytest.raises(ValueError, match=f"zero_stage={z}"):
            check_zero_stage(ParallelPlan(zero_stage=z))
        with pytest.raises(ValueError, match=f"zero_stage={z}"):
            ep.parallel_plan(zero_stage=z)


def test_gather_fsdp_is_the_identity_without_a_mesh():
    """Without an env (or with a dp axis of one rank) the gather at use
    returns its input, and an ``LM`` without ``fsdp`` gathers nothing."""
    x = torch.randn(4, 6)
    assert S.gather_fsdp([x], [0])[0] is x
    assert S.gather_at_use({"a": x}, None)["a"] is x
    assert S.gather_at_use({"a": x}, {"a": 1})["a"] is x
    one = {"pp": 1, "data": 1, "model": 2}
    with S.shard_env(_Stub(one), MESH_RULES):
        assert S.gather_fsdp([x], [1])[0] is x
    sh = lm_shard(get_config("tinyllama-1.1b"), one, MESH_RULES,
                  {"pp": 0, "data": 0, "model": 0}, 3)
    assert not sh.sliced and sh.fsdp_tree() is None


def test_train_refuses_pipe_axes_and_unported_models():
    """``train(mesh=)`` runs a mesh of pp 1; tp not dividing the query
    heads keeps its ValueError (naming ROADMAP item 3b.4'); the
    encoder-decoder and the VLM under tp (paligemma's one K/V head
    replicated over the tp ranks), MoE under dp and Mamba-2 under tp are
    taken."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.configs.base import OptimizerConfig
    ocfg = OptimizerConfig()
    with pytest.raises(ValueError, match="pp=1"):
        make_train_step(get_reduced("tinyllama-1.1b"), ParallelPlan(),
                        ocfg, 2, device="cpu",
                        mesh=Mesh(2, 1, 1, 0, "gloo", "cpu"))
    with pytest.raises(ValueError, match="num_heads=4.*3b.4'"):
        make_train_step(get_reduced("paligemma-3b"), ParallelPlan(),
                        ocfg, 2, device="cpu",
                        mesh=Mesh(1, 1, 8, 0, "gloo", "cpu"))
    for arch in ("whisper-base", "paligemma-3b"):
        step, _ = make_train_step(get_reduced(arch), ParallelPlan(), ocfg,
                                  2, device="cpu",
                                  mesh=Mesh(1, 1, 2, 0, "gloo", "cpu"))
        assert any(step.shard.kv) == (arch == "paligemma-3b")
    for arch, dp, tp in (("qwen2-moe-a2.7b", 2, 1), ("mamba2-2.7b", 1, 2)):
        step, _ = make_train_step(get_reduced(arch), ParallelPlan(), ocfg,
                                  2, device="cpu",
                                  mesh=Mesh(1, dp, tp, 0, "gloo", "cpu"))
        assert step.shard is not None


# ---------------------------------------------------------------------------
# (A) the pipeline at ZeRO-3 on pp 2 x dp 2 x tp 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh222():
    cases = [(CASES[n], z, w) for n, z, w in GRAD_RUNS]
    runs = [(_tc(zero_stage=3), 2, {"overlap": True, "log": H.quiet})]
    outs = spawn(8, Z.pipeline_suite, args=(cases, runs), shape=(2, 2, 2),
                 device="cpu", timeout_s=SPAWN_TIMEOUT)
    return {"grads": {(n, z): [o["grads"][i] for o in outs]
                      for i, (n, z, _) in enumerate(GRAD_RUNS)},
            "train": [o["train"][0] for o in outs]}


def test_stage3_gradients_match_jax_autodiff(mesh222):
    """The gradients the eight ranks hold as their dp slices (of the
    fsdp block leaves) and tp shards, joined, against ``jax.grad`` of
    the JAX ``LM.loss`` over the global batch on the JAX weights."""
    c = CASES["jax-weights"]
    spec = H.spec_of(c)
    got = Z.join_pipeline(spec, SHAPE, mesh222["grads"]["jax-weights", 3],
                          3)
    params = H.full_params(c, spec)
    vg = jax.jit(jax.value_and_grad(
        lambda p, tokens: sum(JaxLM(jax_get_reduced("tinyllama-1.1b")).loss(
            p, {"tokens": tokens[i]})[0] for i in range(tokens.shape[0]))))
    loss, ref = vg(jax.tree.map(jnp.asarray, tree_map(
        lambda a: a.numpy().copy(), unstage_params(params, spec.layout))),
        c["tokens"].astype(np.int32))
    ours = tree_leaves(unstage_params(got, spec.layout))
    theirs = jax.tree.leaves(ref)
    assert len(ours) == len(theirs)
    errs = [float(np.abs(a.numpy() - np.asarray(b)).max())
            for a, b in zip(ours, theirs)]
    e_loss = abs(float(mesh222["grads"]["jax-weights", 3][0]["loss"])
                 - float(loss) / spec.table.m)
    print(f"stage 3 (2,2,2) vs jax.grad: max |d grad| {max(errs):.3e}, "
          f"|d loss| {e_loss:.3e}")
    assert max(errs) <= GRAD_TOL and e_loss <= GRAD_TOL


def test_stage3_gradients_match_stage1(mesh222):
    """Stage 3 against stage 1 on the same weights and batch: the same
    loss on every rank, every joined gradient leaf within ``REL`` (the
    dp sum is taken per op, a reduce-scatter of each op's gradients,
    where stage 1 sums the step's local sums once: the additions
    regroup, so the two agree to rounding, not bitwise)."""
    spec = H.spec_of(CASES["jax-weights"])
    one = Z.join_pipeline(spec, SHAPE, mesh222["grads"]["jax-weights", 1],
                          1)
    three = Z.join_pipeline(spec, SHAPE,
                            mesh222["grads"]["jax-weights", 3], 3)
    errs = [_rel(a.float(), b) for a, b in zip(tree_leaves(three),
                                               tree_leaves(one))]
    print(f"stage 3 vs stage 1: max rel {max(errs):.3e}, bitwise "
          f"{all(torch.equal(a, b) for a, b in zip(tree_leaves(three), tree_leaves(one)))}")
    assert max(errs) <= REL
    losses = {float(r["loss"]) for z in (1, 3)
              for r in mesh222["grads"]["jax-weights", z]}
    assert len(losses) == 1


def test_stage3_masked_matches_the_one_device_executor(mesh222):
    """A mask whose counts differ across the dp ranks, at stage 3:
    gradients and loss against the one-device executor on the global
    batch."""
    c = CASES["masked"]
    spec = H.spec_of(c)
    got = Z.join_pipeline(spec, SHAPE, mesh222["grads"]["masked", 3], 3)
    ref = H.one_device(c, 2)
    for r in mesh222["grads"]["masked", 3]:
        assert abs(float(r["loss"]) - float(ref["loss"])) \
            <= REL * abs(float(ref["loss"]))
        assert r["n"] == spec.table.m
    errs = [_rel(a, b) for a, b in zip(tree_leaves(got),
                                       tree_leaves(ref["g"]), strict=True)]
    assert max(errs) <= REL, errs


def test_stage3_rank_holds_its_slices_between_ops(mesh222):
    """Each stage-3 rank holds 1/dp of every fsdp block leaf and of its
    gradient, the gradient in fp32, and no gathered leaf outlives the op
    that gathered it."""
    spec = H.spec_of(CASES["jax-weights"])
    for r in mesh222["grads"]["jax-weights", 3]:
        sh = Z.rank_shard(spec, SHAPE, r["coords"], 3)
        whole = Z.rank_shard(spec, SHAPE, r["coords"], 1)
        stage1 = [tuple(s) for s in mesh222["grads"]["jax-weights", 1][
            0]["param_shapes"]]
        held = r["held"]
        assert held["ops"] > 0 and held["gathers"] > 0
        assert held["live_max"] == 0
        blocks = [i for i, p in enumerate(sh.paths) if p[0] == "blocks"]
        for j, i in enumerate(blocks):
            k = sh.fsdp_dims[i]
            shape, dtype = held["acc"][j]
            if k is None:
                assert shape == r["param_shapes"][i]
                continue
            assert whole.fsdp_dims[i] is None
            want = list(stage1[i])
            want[k] //= SHAPE["data"]
            assert r["param_shapes"][i] == tuple(want)
            assert shape == tuple(want) and dtype == "torch.float32"
            g = tree_leaves(r["g"])[i]
            assert tuple(g.shape) == tuple(want) and g.dtype == torch.float32
        assert any(sh.fsdp_dims[i] is not None for i in blocks)


@pytest.mark.parametrize("name,zero_stage", [(n, z) for n, z, _ in
                                             GRAD_RUNS])
def test_stage3_bytes_are_collective_stats(name, zero_stage, mesh222):
    """The bytes the ranks hand to collectives in one gradient pass, by
    axis, equal ``collective_stats(zero_stage=)``'s count (at stage 3 the
    ops' gathers and reduce-scatters instead of the fsdp blocks'
    all-reduce)."""
    c = CASES[name]
    ranks = mesh222["grads"][name, zero_stage]
    stats = dryrun.collective_stats(H.spec_of(c), 2, 2, masked=c["mask"]
                                    is not None, update=False,
                                    zero_stage=zero_stage)
    for ax in ("pp", "data", "model"):
        assert sum(r["bytes"][ax] for r in ranks) == stats.by_axis[ax], ax
    kinds = stats.bytes_by_kind
    assert (kinds.get("all-gather-fsdp", 0) > 0) == (zero_stage == 3)
    assert (kinds.get("reduce-scatter-fsdp", 0) > 0) == (zero_stage == 3)


def test_stage3_train_pipeline_tracks_one_device(mesh222):
    """Three overlapped steps of ``train_pipeline(mesh=)`` at stage 3
    against the one-device run on the same global batches: losses and
    gradient norms within ``REL``, the weights the ranks hold whole
    bitwise equal over dp and tp after every step, each step's bytes by
    axis ``collective_stats(zero_stage=3)``'s (no ZeRO-1 all-gather of
    the fsdp blocks)."""
    tc = _tc(zero_stage=3)
    one = train_pipeline(dataclasses.replace(tc, plan=dataclasses.replace(
        tc.plan, microbatch_size=4)), P=2, device="cpu", log=H.quiet)
    ranks = mesh222["train"]
    coll = dryrun.collective_stats(H.spec_of(H.case()), 2, 2, update=True,
                                   zero_stage=3)
    for r in ranks:
        assert r["steps"] == STEPS
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=REL,
                                   atol=0)
        np.testing.assert_allclose(r["grad_norms"], one["grad_norms"],
                                   rtol=REL, atol=0)
        assert r["replicas_equal"] == [True] * STEPS
    assert len({tuple(r["losses"]) for r in ranks}) == 1
    for step in range(STEPS):
        for ax in ("pp", "data", "model"):
            assert sum(r["exchange"]["axis_bytes"][step][ax]
                       for r in ranks) == coll.by_axis[ax], (step, ax)


# ---------------------------------------------------------------------------
# (B) train() on 1 x dp 2 x tp 2
# ---------------------------------------------------------------------------

def _jax_train(tmp):
    """The JAX ``train()`` over 3 steps from ``LM.init(key(SEED))`` (one
    device, the global microbatch of two sequences), its final state
    read back from its checkpoint; and those weights as numpy."""
    jcfg = jax_get_reduced("tinyllama-1.1b")
    jtc = JB.TrainConfig(
        model=jcfg, shape=JB.ShapeConfig("t", Z.TRAIN_SEQ, Z.GLOBAL_BATCH,
                                         "train"),
        plan=JB.ParallelPlan(num_chunks=2, microbatch_size=2,
                             recompute=JB.RecomputeConfig(mode="chronos")),
        optimizer=JB.OptimizerConfig(**Z.OCFG), seed=Z.SEED, log_every=1,
        checkpoint_dir=str(tmp))
    jout = jax_train_module.train(jtc, steps=3, log=lambda s: None)
    jp, _ = JaxLM(jcfg).init(jax.random.key(Z.SEED))
    restored, extra = JaxCheckpointer(str(tmp)).restore(
        {"params": jp, "opt": jax_adamw_init(jp)})
    assert extra["step"] == 3
    return jout, restored, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def train122(tmp_path_factory):
    jout, restored, np_params = _jax_train(tmp_path_factory.mktemp("jax"))
    outs = spawn(4, Z.train_suite, args=(np_params, TRAIN_STAGES),
                 shape=(1, 2, 2), device="cpu", timeout_s=SPAWN_TIMEOUT)
    return {"jax": jout, "restored": restored, "np": np_params,
            "ranks": {z: [o[z] for o in outs] for z in TRAIN_STAGES},
            "period": [o["period"] for o in outs]}


@pytest.mark.parametrize("zero_stage", TRAIN_STAGES)
def test_train_on_the_mesh_matches_jax_train(zero_stage, train122):
    """Three steps of ``train(tc, mesh=)`` on (1, 2, 2) against the JAX
    ``train()`` from the same weights and batches: the losses, and the
    optimizer state joined from the ranks' slices and shards (mu and
    the fp32 masters) against the JAX run's final state; the weights
    (fp32: the masters) equal to the joined masters."""
    ranks = train122["ranks"][zero_stage]
    restored = train122["restored"]
    tree = Z.lm_tree(train122["np"])
    for r in ranks:
        np.testing.assert_allclose(r["losses"], train122["jax"]["losses"],
                                   rtol=0, atol=LOSS_TOL)
    assert len({tuple(r["losses"]) for r in ranks}) == 1
    mu = Z.join_lm(ranks, "mu", SHAPE_B, tree)
    master = Z.join_lm(ranks, "master", SHAPE_B, tree)
    params = Z.join_lm(ranks, "params", SHAPE_B, tree)

    def diffs(ours, key):
        return np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel()
                               for a, b in zip(tree_leaves(ours),
                                               jax.tree.leaves(
                                                   restored["opt"][key]))])
    d_mu, d_w = diffs(mu, "mu"), diffs(master, "master")
    frac = float((d_w > W_TOL).mean())
    print(f"stage {zero_stage} (1,2,2) after 3 steps: max |port - jax| mu "
          f"{d_mu.max():.3e}, master {d_w.max():.3e}; beyond {W_TOL:g}: "
          f"{frac:.2e}")
    assert d_mu.max() <= MU_TOL
    assert frac <= W_FRAC and d_w.max() <= 2 * Z.OCFG["lr"] * 3
    for w, m in zip(tree_leaves(params), tree_leaves(master)):
        assert torch.equal(w, m)


def test_train_on_the_mesh_is_the_same_at_every_stage(train122):
    """Stages 1, 2 and 3 of ``train(mesh=)`` at dp 2 give the same
    losses, gradient norms and final masters bitwise: each microbatch's
    gradients reach the fp32 slices through a reduce-scatter of the same
    two operands, whether the leaf's gather does it (stage 3, a layer at
    a time) or the step does (a stacked leaf at once).  At dp 4 the
    reduce-scatter may associate its four operands by the message's
    size, and the stages agree to rounding (the smoke's phase 29)."""
    tree = Z.lm_tree(train122["np"])
    base = train122["ranks"][1]
    m1 = Z.join_lm(base, "master", SHAPE_B, tree)
    for z in (2, 3):
        ranks = train122["ranks"][z]
        assert [r["losses"] for r in ranks] == [r["losses"] for r in base]
        assert [r["grad_norms"] for r in ranks] == \
            [r["grad_norms"] for r in base]
        mz = Z.join_lm(ranks, "master", SHAPE_B, tree)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(mz),
                                                     tree_leaves(m1)))


@pytest.mark.parametrize("zero_stage", TRAIN_STAGES)
def test_train_on_the_mesh_holds_its_part(zero_stage, train122):
    """What a rank holds: the tp shards, and at stage 3 the dp slice of
    every leaf the reference keeps fsdp on (1/dp of it), the state's
    slices at every stage; the replicas equal after every step; the
    bridge's cut of the JAX tree equal to the shard's."""
    whole = [tuple(a.shape) for a in tree_leaves(
        lm_params_from_meta(Z.train_config(zero_stage).model))]
    for r in train122["ranks"][zero_stage]:
        assert r["bridge_equal"]
        assert all(all(c.values()) for c in r["replica_checks"])
        assert len(r["replica_checks"]) == STEPS
        sliced = [k is not None for k in r["fsdp_dims"]]
        assert any(sliced) == (zero_stage == 3)
        for i, (p, full) in enumerate(zip(tree_leaves(r["params"]), whole)):
            n = 1
            for ax in r["param_specs"][i]:
                for a in ((ax,) if isinstance(ax, str) else ax or ()):
                    n *= SHAPE_B[a]
            assert p.numel() * n == int(np.prod(full))
            assert sliced[i] == S.names_axis(r["param_specs"][i], "data")


def lm_params_from_meta(cfg):
    return LM(cfg, device="meta").init(None)


@pytest.mark.parametrize("zero_stage", TRAIN_STAGES)
def test_train_bytes_are_train_collective_stats(zero_stage, train122):
    """Each step's bytes handed to collectives, by axis and summed over
    the four ranks, equal ``train_collective_stats``' count."""
    tc = Z.train_config(zero_stage)
    stats = dryrun.train_collective_stats(
        tc.model, m=2, mbB=1, seq_len=Z.TRAIN_SEQ, dp=2, tp=2,
        zero_stage=zero_stage)
    ranks = train122["ranks"][zero_stage]
    for step in range(STEPS):
        got = {ax: sum(r["axis_bytes"][step][ax] for r in ranks)
               for ax in ("pp", "data", "model")}
        assert got == stats.by_axis, step
    kinds = stats.bytes_by_kind
    assert (kinds["all-gather-fsdp"] > 0) == (zero_stage == 3)
    assert (kinds["all-gather-dp"] > 0) and kinds["all-reduce-tp"] > 0


def test_train_bytes_count_the_recompute_of_a_long_period(train122):
    """One step of reduced gemma3-27b (one checkpointed period of six
    layers) at stage 3 on (1, 2, 2): the recompute stops at the period's
    last saved tensor, so of its tp sums only the last layer's MLP one is
    not run again; the bytes by axis equal ``train_collective_stats``'."""
    tc = Z.train_config(3, Z.PERIOD_ARCH)
    assert tc.model.period == tc.model.num_layers == 6
    stats = dryrun.train_collective_stats(
        tc.model, m=2, mbB=1, seq_len=Z.TRAIN_SEQ, dp=2, tp=2, zero_stage=3)
    got = {ax: sum(r[0][ax] for r in train122["period"])
           for ax in ("pp", "data", "model")}
    assert got == stats.by_axis


def test_train_entry_point_keeps_its_default_device():
    """``train`` still runs on the card unless told (its ``device``
    default), with or without a mesh."""
    import inspect
    assert inspect.signature(train).parameters["device"].default == "cuda"
    assert inspect.signature(train).parameters["mesh"].default is None
