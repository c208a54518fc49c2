"""Mamba-2 and MoE layers on a ``pp x dp x tp`` mesh, on the CPU: gloo
ranks holding CPU tensors (``tests/helpers/torch_families.py`` holds the
rank bodies), reduced mamba2-2.7b (attention-free, 8 SSM heads),
qwen2-moe-a2.7b (8 experts top-4 with shared experts and q/k/v biases,
at a capacity factor that drops tokens, set on both packages' configs)
and jamba-v0.1-52b (the hybrid: Mamba-2, attention with 8 heads and 2
K/V heads, and MoE layers), all fp32.

- (A) the rank executor on pp 2 x dp 2 x tp 2 (chronos_zb P=2 v=2 m=4,
  jamba at v=1, two sequences of 17 tokens a dp rank a microbatch) from
  the JAX package's weights, at ZeRO stages 1 and 3: the Mamba-2
  channels and heads split over tp with the gated norm's rows across
  the ranks, the experts' hidden width over tp, the MoE routing over the
  global microbatch; one MoE layer alone against the JAX ``moe_ffn``
  with its drops; the split-width RMSNorm's plain passes over a tp group
  of 2.
- (B) ``train(tc, mesh=)`` on 1 x dp 2 x tp 2 against the JAX
  ``train()``.

The oracle is ``jax.grad`` of the JAX ``LM.loss`` on the global batch,
summed over the microbatches (never the JAX pipelined executor).
Tolerances: gradients and loss ``GRAD_TOL`` 1e-5 absolute
(``tests/test_torch_mesh.py``'s); stage 3 against stage 1 ``ZERO3_REL``
2e-5 relative to each leaf's largest element; the split norm against
``rmsnorm_rows_ref`` over the whole row ``NORM_REL`` 1e-6 relative; one
MoE layer's weight gradients ``LEAF_REL`` 1e-5 relative to each leaf's
largest element;
``train()`` at ``tests/test_torch_zero.py``'s bounds; the bytes the
ranks hand to collectives, by axis, equal to ``collective_stats`` and
``train_collective_stats`` exactly.  One spawn of eight ranks and one of
four, each under its own timeout (``SPAWN_TIMEOUT``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import get_reduced as jax_get_reduced
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.ft import Checkpointer as JaxCheckpointer
from repro.launch import train as jax_train_module
from repro.models import LM as JaxLM
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.core.pipeline_runtime import unstage_params
from repro_torch.kernels.rmsnorm import rmsnorm_rows_ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn
from repro_torch.models.moe import capacity
from repro_torch.tree import tree_leaves, tree_map
from helpers import torch_families as Fam
from helpers import torch_mesh as H
from helpers import torch_zero as Z
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPAWN_TIMEOUT = 240          # seconds, each spawn of ranks
GRAD_TOL = 1e-5
ZERO3_REL = 2e-5
NORM_REL = 1e-6
# the MoE layer's weight gradients, relative to each leaf's largest
# element: the dp ranks' partial sums add in another order than one sum
# over the global rows, and the whole shared expert's reach ~10
LEAF_REL = 1e-5
LOSS_TOL, MU_TOL, W_TOL, W_FRAC = 1e-5, 1e-6, 1e-6, 1e-3
SHAPE = {"pp": 2, "data": 2, "model": 2}
SHAPE_B = {"pp": 1, "data": 2, "model": 2}
ARCHS = ("mamba2-2.7b", "qwen2-moe-a2.7b", "jamba-v0.1-52b")
# reduced qwen2-moe's capacity factor 8.0 drops no token; at 1.0 the
# global capacity (32 slots at 64 tokens, top-4 of 8 experts) drops some
DROP_CF = 1.0
CF = {"qwen2-moe-a2.7b": DROP_CF}
TRAIN_ARCHS = ("mamba2-2.7b", "qwen2-moe-a2.7b")
STAGES = (1, 3)


def _jax_cfg(arch):
    cfg = jax_get_reduced(arch)
    if arch in CF:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CF[arch]))
    return cfg


# chunks a stage: jamba's period of 8 layers pads its 8 to 32 at v=2,
# to 16 at v=1
V = {"jamba-v0.1-52b": 1}


@functools.lru_cache(maxsize=None)
def _case(arch):
    """The (2, 2, 2) case of ``arch`` on the JAX package's
    ``init_pipeline_params`` weights (P=2, ``V`` chunks a stage, 2 by
    default)."""
    cfg = _jax_cfg(arch)
    v = V.get(arch, 2)
    params, _ = jax_init_pipeline_params(jax.random.key(0), cfg,
                                         JaxStageLayout.build(cfg, 2, v))
    port_cfg = {"moe": Fam.reduced(arch, CF[arch]).moe} if arch in CF \
        else None
    return H.case(arch, params=jax.tree.map(np.asarray, params),
                  cfg=port_cfg, v=v)


RUNS = [(a, z) for a in ARCHS for z in STAGES]

# the split-width norm: 6 rows of 64 columns (32 a tp rank)
_rng = np.random.default_rng(7)
NORM = {"x": _rng.standard_normal((6, 64)).astype(np.float32),
        "scale": (1.0 + 0.1 * _rng.standard_normal(64)).astype(np.float32),
        "dy": _rng.standard_normal((6, 64)).astype(np.float32), "eps": 1e-6}


# one MoE layer of reduced qwen2-moe at the dropping capacity factor: its
# own shared experts (2 x 128, split over tp with the experts' sum), and
# one shared expert of width 65, which tp 2 does not divide (whole on
# every rank, added after the experts' sum)
MOE_SHARED = {"split-shared": {}, "whole-shared": dict(num_shared_experts=1,
                                                       d_ff_shared=65)}


def _moe_cfgs(name):
    """(JAX config, port config) of the ``MOE_SHARED[name]`` layer."""
    jcfg, cfg = _jax_cfg("qwen2-moe-a2.7b"), Fam.reduced("qwen2-moe-a2.7b",
                                                         DROP_CF)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, **MOE_SHARED[name])), dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, **MOE_SHARED[name])))


@functools.lru_cache(maxsize=None)
def _moe_inputs(name):
    """The layer's JAX ``init_moe`` weights, a global x of 4 rows of 16
    tokens (two rows a dp rank) and the output's gradient."""
    from repro.models.moe import init_moe
    cfg = _moe_cfgs(name)[0]
    p, _ = init_moe(jax.random.key(3), cfg.d_model, cfg.moe, cfg.act,
                    jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    return jax.tree.map(np.asarray, p), x, dy


LB_WEIGHT = 0.37


@pytest.fixture(scope="module")
def mesh222():
    moe = [dict(zip(("layer", "x", "dy"), _moe_inputs(n)),
                cfg=_moe_cfgs(n)[1], lb_weight=LB_WEIGHT) for n in MOE_SHARED]
    outs = spawn(8, Fam.families_suite,
                 args=([(_case(a), z) for a, z in RUNS], NORM, moe),
                 shape=(2, 2, 2), device="cpu", timeout_s=SPAWN_TIMEOUT)
    return {"grads": {(a, z): [o["grads"][i] for o in outs]
                      for i, (a, z) in enumerate(RUNS)},
            "norm": [o["norm"] for o in outs],
            "moe": {n: [o["moe"][i] for o in outs]
                    for i, n in enumerate(MOE_SHARED)}}


_JAX_VG = {}


def _jax_value_and_grad(arch, params, tokens):
    """``jax.grad`` of the JAX ``LM.loss`` summed over the microbatches of
    the global batch (one compiled microbatch, called for each)."""
    if arch not in _JAX_VG:
        lm = JaxLM(_jax_cfg(arch))
        _JAX_VG[arch] = jax.jit(jax.value_and_grad(
            lambda p, t: lm.loss(p, {"tokens": t})[0]))
    outs = [_JAX_VG[arch](params, t) for t in tokens]
    return (sum(o[0] for o in outs),
            jax.tree.map(lambda *g: sum(g), *[o[1] for o in outs]))


def _rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-12))


@pytest.mark.parametrize("arch", ARCHS)
def test_families_match_jax_autodiff(arch, mesh222):
    """The gradients the eight ranks hold (their pp column, tp shard),
    joined, and the loss against ``jax.grad`` of the JAX ``LM.loss`` over
    the global batch on the JAX weights; the bridge cut every rank's
    stacked Mamba-2 and MoE leaves as its shard's logical specs say."""
    c = _case(arch)
    spec = H.spec_of(c)
    ranks = mesh222["grads"][arch, 1]
    assert all(r["bridge_equal"] for r in ranks)
    assert len({float(r["loss"]) for r in ranks}) == 1
    got = H.gather(spec, SHAPE, ranks)
    params = H.full_params(c, spec)
    loss, ref = _jax_value_and_grad(arch, jax.tree.map(jnp.asarray, tree_map(
        lambda a: a.numpy().copy(), unstage_params(params, spec.layout))),
        c["tokens"].astype(np.int32))
    ours = tree_leaves(unstage_params(got, spec.layout))
    theirs = jax.tree.leaves(ref)
    assert len(ours) == len(theirs)
    errs = [float(np.abs(a.numpy() - np.asarray(b)).max())
            for a, b in zip(ours, theirs)]
    e_loss = abs(float(ranks[0]["loss"]) - float(loss) / spec.table.m)
    print(f"{arch} (2,2,2) vs jax.grad: max |d grad| {max(errs):.3e}, "
          f"|d loss| {e_loss:.3e}")
    assert max(errs) <= GRAD_TOL and e_loss <= GRAD_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_families_stage3_match_stage1(arch, mesh222):
    """ZeRO stage 3 (each rank holding its dp slice of every block leaf
    the reference keeps fsdp on: ``wz`` / ``wx`` / ``wo``, the experts'
    ``wi`` / ``wg`` / ``wo``, ...) against stage 1 on the same weights and
    batch: every joined gradient leaf within ``ZERO3_REL``, the loss
    within it on every rank."""
    spec = H.spec_of(_case(arch))
    one = Z.join_pipeline(spec, SHAPE, mesh222["grads"][arch, 1], 1)
    three = Z.join_pipeline(spec, SHAPE, mesh222["grads"][arch, 3], 3)
    errs = [_rel(a.float(), b) for a, b in zip(tree_leaves(three),
                                               tree_leaves(one))]
    print(f"{arch} stage 3 vs stage 1: max rel {max(errs):.3e}")
    assert max(errs) <= ZERO3_REL
    l1 = float(mesh222["grads"][arch, 1][0]["loss"])
    for r in mesh222["grads"][arch, 3]:
        assert abs(float(r["loss"]) - l1) <= ZERO3_REL * abs(l1)
    sliced = Z.rank_shard(spec, SHAPE, {"pp": 0, "data": 0, "model": 0}, 3)
    names = {p[-1] for p, k in zip(sliced.paths, sliced.fsdp_dims)
             if k is not None}
    want = {"mamba2-2.7b": {"wz", "wx", "wo", "wB", "wC", "wdt"},
            "qwen2-moe-a2.7b": {"wi", "wg", "wo", "wq", "wk", "wv"}}
    assert want.get(arch, set()) <= names


@pytest.mark.parametrize("arch,zero_stage", RUNS)
def test_families_bytes_are_collective_stats(arch, zero_stage, mesh222):
    """The bytes the ranks hand to collectives in one gradient pass, by
    axis, equal ``collective_stats``' count: with the Mamba-2 norm's row
    sums, B and C's backward sums, the MoE gates' backward sum, the
    experts' output sum and the routing's expert counts over dp."""
    spec = H.spec_of(_case(arch))
    ranks = mesh222["grads"][arch, zero_stage]
    stats = dryrun.collective_stats(spec, 2, 2, update=False,
                                    zero_stage=zero_stage)
    for ax in ("pp", "data", "model"):
        assert sum(r["bytes"][ax] for r in ranks) == stats.by_axis[ax], ax
    assert ("all-gather-route" in stats.bytes_by_kind) == \
        (spec.cfg.moe is not None)


def _local_routing(probs, cfg, T_rank):
    """What rank-local routing would give on each dp rank's tokens: the
    keep masks (flat (token, pick) order, the ranks' joined) and the
    ranks' ``lb_loss``."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    keeps, lbs = [], []
    for r in range(probs.shape[0] // T_rank):
        p = probs[r * T_rank:(r + 1) * T_rank]
        keeps.append(Fam.keep_mask(p, K, capacity(T_rank, cfg.moe)))
        idx = np.argsort(-p, axis=1, kind="stable")[:, :K]
        ce = np.bincount(idx.reshape(-1), minlength=E) / T_rank
        lbs.append(E * float((p.mean(0) * ce).sum()))
    return np.concatenate(keeps), lbs


@pytest.mark.parametrize("name", list(MOE_SHARED))
def test_moe_layer_routes_over_the_global_microbatch(name, mesh222):
    """One reduced qwen2-moe MoE layer at capacity factor ``DROP_CF`` on
    (2, 2, 2): each rank holds two of the four rows and half of each
    expert's hidden width (and of the shared experts', where tp divides
    it).  Against the JAX ``moe_ffn`` on the global rows: the outputs,
    ``lb_loss`` (the dp ranks' shares summed),
    ``router_fraction_dropped`` (equal on every rank), and the gradients
    of ``sum(y * dy) + w * lb_loss`` (x's rows, the router summed over
    dp, the experts' shards joined over tp and summed over dp).  Tokens
    are dropped, and rank-local routing would keep other tokens and give
    another ``lb_loss``."""
    jcfg, cfg = _moe_cfgs(name)
    layer_np, x_np, dy_np = _moe_inputs(name)
    layer = jax.tree.map(jnp.asarray, layer_np)
    y, aux = jax_moe_ffn(layer, jnp.asarray(x_np), jcfg.moe, jcfg.act)
    lb = float(aux["lb_loss"])
    dropped = float(aux["router_fraction_dropped"])

    def obj(p, x):
        yy, a = jax_moe_ffn(p, x, jcfg.moe, jcfg.act)
        return (yy * dy_np).sum() + LB_WEIGHT * a["lb_loss"]
    gp, gx = jax.grad(obj, argnums=(0, 1))(layer, jnp.asarray(x_np))
    ranks = {(r["coords"]["data"], r["coords"]["model"]): r
             for r in mesh222["moe"][name] if r["coords"]["pp"] == 0}
    got_y = np.concatenate([ranks[d, 0]["y"].numpy() for d in (0, 1)])
    got_dx = np.concatenate([ranks[d, 0]["dx"].numpy() for d in (0, 1)])
    assert all(torch.equal(ranks[d, 0]["y"], ranks[d, 1]["y"])
               for d in (0, 1))
    np.testing.assert_allclose(got_y, np.asarray(y), atol=GRAD_TOL, rtol=0)
    np.testing.assert_allclose(got_dx, np.asarray(gx), atol=GRAD_TOL,
                               rtol=0)
    shares = [ranks[d, 0]["lb_loss"] for d in (0, 1)]
    assert abs(sum(shares) - lb) <= GRAD_TOL
    assert {r["dropped"] for r in mesh222["moe"][name]} == {dropped}
    assert dropped > 0.0
    router = sum(ranks[d, 0]["g"]["router"] for d in (0, 1))
    assert _rel(router, torch.from_numpy(np.asarray(gp["router"]))) \
        <= LEAF_REL

    def joined(get, dim, width):
        """A leaf's gradient summed over dp, joined over tp where tp
        divides ``width`` (else tp rank 0's whole one)."""
        parts = [sum(get(ranks[d, t]) for d in (0, 1))
                 for t in ((0, 1) if width % 2 == 0 else (0,))]
        return torch.cat(parts, dim=dim)
    F = cfg.moe.d_ff_expert
    for k, dim in (("wi", 2), ("wg", 2), ("wo", 1)):
        assert _rel(joined(lambda r: r["g"][k], dim, F),
                    torch.from_numpy(np.asarray(gp[k]))) <= LEAF_REL, k
    ff = cfg.moe.num_shared_experts * cfg.moe.d_ff_shared
    for k, dim in (("wi", 1), ("wg", 1), ("wo", 0)):
        assert _rel(joined(lambda r: r["g"]["shared"][k], dim, ff),
                    torch.from_numpy(np.asarray(gp["shared"][k]))) \
            <= LEAF_REL, k
    # what rank-local routing would decide instead
    probs = np.asarray(jax.nn.softmax(
        x_np.reshape(-1, cfg.d_model) @ layer_np["router"], axis=-1))
    T = probs.shape[0]
    glob = Fam.keep_mask(probs, cfg.moe.top_k, capacity(T, cfg.moe))
    assert abs((1.0 - glob.mean()) - dropped) <= 1e-7
    local, local_lb = _local_routing(probs, cfg, T // 2)
    print(f"MoE layer ({name}): dropped {dropped:.4f} global, "
          f"{1.0 - local.mean():.4f} rank-local; lb_loss {lb:.6f} global "
          f"(shares {shares}), rank-local {local_lb}")
    assert (local != glob).any()
    assert all(abs(x - lb) > 1e-4 for x in local_lb)


def test_split_width_rmsnorm_matches_the_whole_row(mesh222):
    """The split-width RMSNorm's plain passes on two tp halves of each row
    (the sums of squares all-reduced over tp, the backward's row sums
    too): the joined output and gradients against ``rmsnorm_rows_ref``
    over the whole rows under autograd, within ``NORM_REL``."""
    x = torch.from_numpy(NORM["x"]).requires_grad_()
    s = torch.from_numpy(NORM["scale"]).requires_grad_()
    y = rmsnorm_rows_ref(x, s, NORM["eps"])
    y.backward(torch.from_numpy(NORM["dy"]))
    halves = {o["tp"]: o for o in mesh222["norm"]}
    got_y = torch.cat([halves[t]["y"] for t in (0, 1)], dim=1)
    got_dx = torch.cat([halves[t]["dx"] for t in (0, 1)], dim=1)
    got_ds = torch.cat([halves[t]["dscale"] for t in (0, 1)])
    for a, b in ((got_y, y.detach()), (got_dx, x.grad), (got_ds, s.grad)):
        assert _rel(a, b) <= NORM_REL, _rel(a, b)


# ---------------------------------------------------------------------------
# (B) train() on 1 x dp 2 x tp 2
# ---------------------------------------------------------------------------

def _jax_train(arch, tmp):
    """The JAX ``train()`` of reduced ``arch`` over 3 steps from
    ``LM.init(key(SEED))`` (one device, the global microbatch), its
    final state read back from its checkpoint; and those weights as
    numpy."""
    jcfg = _jax_cfg(arch)
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
    jax_runs = {a: _jax_train(a, tmp_path_factory.mktemp(a))
                for a in TRAIN_ARCHS}
    outs = spawn(4, Fam.train_suite,
                 args=([(a, CF.get(a), jax_runs[a][2]) for a in TRAIN_ARCHS],),
                 shape=(1, 2, 2), device="cpu", timeout_s=SPAWN_TIMEOUT)
    return {a: {"jax": jax_runs[a][0], "restored": jax_runs[a][1],
                "np": jax_runs[a][2], "ranks": [o[i] for o in outs]}
            for i, a in enumerate(TRAIN_ARCHS)}


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_on_the_mesh_matches_jax_train(arch, train122):
    """Three steps of ``train(tc, mesh=)`` on (1, 2, 2) at ZeRO stage 1
    against the JAX ``train()`` from the same weights and batches: the
    losses, and the optimizer state joined from the ranks' slices and
    shards (mu and the fp32 masters) against the JAX run's final state;
    the replicas equal after every step; each step's bytes by axis
    ``train_collective_stats``'."""
    run = train122[arch]
    ranks, restored = run["ranks"], run["restored"]
    tree = Z.lm_tree(run["np"])
    for r in ranks:
        np.testing.assert_allclose(r["losses"], run["jax"]["losses"],
                                   rtol=0, atol=LOSS_TOL)
        assert all(all(c.values()) for c in r["replica_checks"])
    assert len({tuple(r["losses"]) for r in ranks}) == 1
    mu = Z.join_lm(ranks, "mu", SHAPE_B, tree)
    master = Z.join_lm(ranks, "master", SHAPE_B, tree)

    def diffs(ours, key):
        return np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel()
                               for a, b in zip(tree_leaves(ours),
                                               jax.tree.leaves(
                                                   restored["opt"][key]))])
    d_mu, d_w = diffs(mu, "mu"), diffs(master, "master")
    frac = float((d_w > W_TOL).mean())
    print(f"{arch} train() (1,2,2) after 3 steps: max |port - jax| mu "
          f"{d_mu.max():.3e}, master {d_w.max():.3e}; beyond {W_TOL:g}: "
          f"{frac:.2e}")
    assert d_mu.max() <= MU_TOL
    assert frac <= W_FRAC and d_w.max() <= 2 * Z.OCFG["lr"] * 3
    tc = Fam.train_config(arch, CF.get(arch))
    stats = dryrun.train_collective_stats(
        tc.model, m=2, mbB=1, seq_len=Z.TRAIN_SEQ, dp=2, tp=2, zero_stage=1)
    for step in range(3):
        got = {ax: sum(r["axis_bytes"][step][ax] for r in ranks)
               for ax in ("pp", "data", "model")}
        assert got == stats.by_axis, step
