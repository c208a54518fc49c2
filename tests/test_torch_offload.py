"""The port's Chronos-Offload against the JAX package: the host AdamW, the
deep/shallow split, the runner, the Eq. (5)/(7) timing model, and
offload pipeline training on the reduced tinyllama and mamba2 (4 layers,
d 128, fp32), P=2, v=2, m=4, two sequences of 17 tokens per microbatch.

The JAX offload driver is no oracle on this JAX version (its phase
executor stops at the loss-head ``lax.cond``, its legacy executor at a
sharding mismatch), so the trajectory oracle is composed from JAX parts
that run: ``jax.grad(LM.loss) / m``; the layers of the port's deep chunk
updated by JAX ``HostAdamW`` and rounded through bf16, as the
reference's upload does; every other leaf by JAX ``adamw_update`` over
the shallow and shared tree (its own gradient norm and clip).  Inputs
are made with numpy from a seed and handed to both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import OffloadConfig as JaxOffloadConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core.analysis import offload_timing as jax_offload_timing
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.models import LM as JaxLM
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.offload import ChronosOffloadRunner as JaxRunner
from repro.optim.offload import HostAdamW as JaxHostAdamW
from repro.optim.offload import merge_deep_shallow as jax_merge
from repro.optim.offload import split_deep_shallow as jax_split
from repro.optim.schedules import lr_at as jax_lr_at
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import (OffloadConfig, OptimizerConfig,
                                      ParallelPlan, ShapeConfig, TrainConfig)
from repro_torch.core.analysis import offload_timing
from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                               make_pipeline_spec,
                                               unstage_params)
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_pipeline_train_step, offload_kept
from repro_torch.launch.train import train_pipeline
from repro_torch.optim import adamw_init, lr_at
from repro_torch.optim.offload import (SLAB, ChronosOffloadRunner, HostAdamW,
                                       merge_deep_shallow, split_deep_shallow)
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("tinyllama-1.1b", "mamba2-2.7b")
P, V, M, MBB, SEQ = 2, 2, 4, 2, 17
OCFG = dict(warmup_steps=1, total_steps=3, lr=1e-3)
# the trajectory bounds of tests/test_torch_train.py: losses at 1e-5,
# first moments at 1e-6, masters at 1e-6 for all but 1e-3 of them and
# within Adam's 2 * lr per step everywhere (a gradient element at the
# rounding noise of its sums)
LOSS_TOL, MU_TOL, W_TOL, W_FRAC = 1e-5, 1e-6, 1e-6, 1e-3
# offload against the port's on-device optimizer, 3 steps: the host
# update skips the clip and decays every deep leaf, and the deep weights
# carry bf16 rounding (the reference's own bound,
# tests/helpers/offload_train_check.py)
OFFLOAD_LOSS_TOL = 5e-3


def _rng_tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# HostAdamW
# ---------------------------------------------------------------------------

SHAPES = {"big": (3, SLAB + 1000), "w": (7, 33), "scale": (129,)}


@pytest.mark.parametrize("threads", [1, 4])
def test_host_adamw_matches_jax_bitwise(threads):
    """3 steps on the same numpy gradients, the clip coefficient != 1 at
    step 2: master, mu and nu bitwise (one leaf spans several slabs, so
    the threaded split is exercised), and the learning rates equal."""
    rng = np.random.default_rng(0)
    params = _rng_tree(rng, SHAPES)
    ours = HostAdamW(params, OptimizerConfig(**OCFG), threads=threads)
    ref = JaxHostAdamW(params, JaxOptimizerConfig(**OCFG))
    try:
        for step, clip in ((1, 1.0), (2, 0.37), (3, 1.0)):
            assert float(lr_at(ours.cfg, step)) == \
                float(jax_lr_at(ref.cfg, step))
            g = _rng_tree(rng, SHAPES)
            ours.update(g, clip)
            ref.update(g, clip)
        for key in ("master", "mu", "nu"):
            for k in SHAPES:
                np.testing.assert_array_equal(getattr(ours, key)[k],
                                              getattr(ref, key)[k])
    finally:
        ours.close()


def test_host_adamw_widens_bf16_and_divides_like_the_reference():
    """bf16 gradient tensors with ``grad_div=m`` give the reference's
    update of ``g.astype(f32) / m`` (that division done by JAX), bitwise."""
    rng = np.random.default_rng(1)
    params = _rng_tree(rng, SHAPES)
    ours = HostAdamW(params, OptimizerConfig(**OCFG), threads=3)
    ref = JaxHostAdamW(params, JaxOptimizerConfig(**OCFG))
    try:
        for _ in range(2):
            g = {k: torch.from_numpy(a).to(torch.bfloat16)
                 for k, a in _rng_tree(rng, SHAPES).items()}
            ours.update(g, grad_div=M)
            ref.update({k: np.asarray(jnp.asarray(t.float().numpy())
                                      .astype(jnp.bfloat16)
                                      .astype(jnp.float32) / M)
                        for k, t in g.items()})
        for k in SHAPES:
            np.testing.assert_array_equal(ours.master[k], ref.master[k])
            np.testing.assert_array_equal(ours.nu[k], ref.nu[k])
    finally:
        ours.close()


# ---------------------------------------------------------------------------
# split / merge, the runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,n", [(2, 1), (3, 1), (3, 2)])
def test_split_and_merge_match_jax(v, n):
    rng = np.random.default_rng(v * 10 + n)
    tree = [{"a": rng.standard_normal((2, v, 3, 4, 5)).astype(np.float32),
             "b": rng.standard_normal((2, v, 3, 6)).astype(np.float32)}]
    ours = tree_map(torch.from_numpy, tree)
    s, d = split_deep_shallow(ours, v, n)
    js, jd = jax_split(jax.tree.map(jnp.asarray, tree), v, n)
    for a, b in zip(tree_leaves(s) + tree_leaves(d),
                    jax.tree.leaves(js) + jax.tree.leaves(jd)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # views of the same storage
    assert all(x.data_ptr() == y.data_ptr()
               for x, y in zip(tree_leaves(s), tree_leaves(ours)))
    merged = merge_deep_shallow(s, d)
    want = jax.tree.leaves(jax_merge(js, jd))
    for a, b in zip(tree_leaves(merged), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # in place: new deep values land in the full leaves, nothing else moves
    d2 = tree_map(lambda x: x + 1.0, d)
    out = merge_deep_shallow(s, d2, out=ours)
    assert out is ours
    want = jax.tree.leaves(jax_merge(js, jax.tree.map(lambda x: x + 1.0, jd)))
    for a, b in zip(tree_leaves(ours), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_runner_uploads_the_jax_runners_bf16_weights():
    """3 submit/collect rounds: the deep views of bf16 parameters equal
    the JAX runner's bf16 results bitwise, the shallow part is untouched,
    and ``stats`` counts every submit."""
    rng = np.random.default_rng(2)
    full = {"w": rng.standard_normal((2, 2, 1, 8, SLAB // 64)).astype(
        np.float32)}
    params = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), full)
    shallow0 = params["w"][:, :1].clone()
    _, deep = split_deep_shallow(params, 2, 1)
    ours = ChronosOffloadRunner(deep, OptimizerConfig(**OCFG))
    jdeep = jax_split(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                   full), 2, 1)[1]
    ref = JaxRunner(jdeep, JaxOptimizerConfig(**OCFG))
    try:
        for _ in range(3):
            g = rng.standard_normal(deep["w"].shape).astype(np.float32)
            gt = torch.from_numpy(g).to(torch.bfloat16)
            ours.submit({"w": gt}, grad_div=M)
            ref.submit({"w": jnp.asarray(gt.float().numpy())
                        .astype(jnp.bfloat16).astype(jnp.float32) / M})
            got = ours.collect()
            want = ref.collect()
            assert got is deep
            np.testing.assert_array_equal(
                got["w"].float().numpy(),
                np.asarray(want["w"].astype(jnp.float32)))
        assert ours.stats["submits"] == ref.stats["submits"] == 3
        assert 0 <= ours.stats["overlapped"] <= 3
        assert torch.equal(params["w"][:, :1], shallow0)
        np.testing.assert_array_equal(ours.opt.master["w"],
                                      ref.opt.master["w"])
        rep = ours.measured()
        assert len(rep["host_update_s"]) == 3
        assert rep["bytes_down"] == rep["bytes_up"] == deep["w"].numel() * 2
    finally:
        ours.close()


def test_runner_counts_overlap_and_raises_the_threads_error():
    deep = {"w": torch.zeros((2, 1, 1, 4))}
    runner = ChronosOffloadRunner(deep, OptimizerConfig(**OCFG))
    try:
        runner.submit({"w": torch.ones((2, 1, 1, 4))})
        with pytest.raises(RuntimeError, match="not collected"):
            runner.submit({"w": torch.ones((2, 1, 1, 4))})
        runner._thread.join(timeout=30)            # the update has ended
        runner.collect()
        assert runner.stats == {"submits": 1, "overlapped": 1}
        assert float(deep["w"][0, 0, 0, 0]) < 0.0     # moved against g

        def boom(*a, **k):
            raise FloatingPointError("host update failed")
        runner.opt.update = boom
        runner.submit({"w": torch.ones((2, 1, 1, 4))})
        with pytest.raises(FloatingPointError, match="host update failed"):
            runner.collect()
        with pytest.raises(RuntimeError, match="without a submit"):
            runner.collect()
    finally:
        runner.close()


# ---------------------------------------------------------------------------
# config and the timing model, full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_offload_timing_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert dataclasses.asdict(OffloadConfig()) == dataclasses.asdict(
        JaxOffloadConfig())
    for kw in (dict(seq_len=2049, microbatch=1, pp=4, tp=1,
                    offload_frac=0.5),
               dict(seq_len=4096, microbatch=2, pp=8, tp=8, dp=2,
                    pcie_gbps=16.0, cpu_flops=1e12, offload_frac=0.25)):
        ours, ref = offload_timing(cfg, **kw), jax_offload_timing(jcfg, **kw)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        for prop in ("available_offload", "available_upload", "offload_ok",
                     "upload_ok", "overlap_ratio", "exposed_time"):
            assert getattr(ours, prop) == getattr(ref, prop), prop


# ---------------------------------------------------------------------------
# the offload step and pipeline training
# ---------------------------------------------------------------------------

def _plan(offload, schedule="chronos_zb", kernels="fused", n_off=1):
    return ParallelPlan(schedule=schedule, num_chunks=V, microbatch_size=MBB,
                        num_microbatches=M, kernels=kernels,
                        offload=OffloadConfig(enabled=offload,
                                              num_offload_chunks=n_off))


def test_offload_step_returns_the_deep_gradients():
    """The dry contract of the reference's offload step: device optimizer
    elements < parameter elements <= device optimizer elements + deep
    gradient elements; the step returns the deep gradients and leaves
    the deep weights as they were."""
    cfg = get_reduced("tinyllama-1.1b")
    plan = _plan(True)
    step, m, _, spec = make_pipeline_train_step(
        cfg, ShapeConfig("t", SEQ, M * MBB, "train"), plan,
        OptimizerConfig(**OCFG), P=P, device="cpu")
    params = init_pipeline_params(torch.Generator().manual_seed(0), cfg,
                                  spec.layout, "cpu")
    kept, deep = offload_kept(params, plan)
    deep0 = tree_map(torch.clone, deep)
    opt = adamw_init(kept)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (M, MBB, SEQ)).astype(np.int32)
    out = step(params, opt, {"tokens": torch.from_numpy(toks)})
    assert out.shipment is not None and out.ef is None
    n_opt = sum(a.numel() for a in tree_leaves(opt["mu"]))
    n_par = sum(a.numel() for a in tree_leaves(params))
    n_deep = sum(a.numel() for a in tree_leaves(out.shipment))
    assert 0 < n_opt < n_par <= n_opt + n_deep
    assert [tuple(g.shape) for g in tree_leaves(out.shipment)] == \
        [tuple(a.shape) for a in tree_leaves(deep)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(deep),
                                                 tree_leaves(deep0)))
    assert all(a.is_contiguous() for a in tree_leaves(opt["master"]))


def _redraw(tree, seed):
    """A Mamba-2 tree's A_log, D, dt_bias and norm scales redrawn (numpy,
    in place), so no gradient is trivially zero."""
    rng = np.random.default_rng(seed)
    ranges = {"A_log": (-0.5, 0.5), "D": (0.5, 1.5),
              "dt_bias": (-3.0, -1.0), "scale": (0.5, 1.5),
              "norm_scale": (0.5, 1.5)}

    def walk(t):
        for k, v in (t.items() if isinstance(t, dict) else enumerate(t)):
            if isinstance(v, (dict, list)):
                walk(v)
            elif k in ranges:
                t[k] = rng.uniform(*ranges[k], v.shape).astype(v.dtype)
    walk(tree)
    return tree


def _bridged(arch):
    """The JAX ``init_pipeline_params`` weights of the reduced ``arch`` at
    (P, V), as a torch tree."""
    jcfg = jax_get_reduced(arch)
    params, _ = jax_init_pipeline_params(
        jax.random.key(0), jcfg, JaxStageLayout.build(jcfg, P, V))
    return lm_params_from_numpy(
        _redraw(jax.tree.map(np.asarray, params), 10), "cpu")


def _deep_rows(spec, params):
    """Per period position, the rows of the ``LM`` tree's stacked layers
    that lie in the deep chunk (by the port's layout)."""
    marker = {**params, "blocks": [
        tree_map(lambda a: torch.arange(V).view(1, V, 1)
                 .expand(a.shape[:3]).clone(), t) for t in params["blocks"]]}
    lm = unstage_params(marker, spec.layout)
    return [np.asarray(tree_leaves(t)[0].numpy() >= V - 1)
            for t in lm["layers"]]


def _split_lm(tree, rows):
    """An ``LM`` tree -> (shallow and shared, deep) by stacked-layer rows."""
    shallow = {**tree, "layers": [jax.tree.map(lambda a, r=r: a[~r], t)
                                  for t, r in zip(tree["layers"], rows)]}
    deep = {"layers": [jax.tree.map(lambda a, r=r: a[r], t)
                       for t, r in zip(tree["layers"], rows)]}
    return shallow, deep


def _merge_lm(shallow, deep, rows):
    def put(s, d, r):
        out = np.zeros((len(r),) + s.shape[1:], np.float32)
        out[~r], out[r] = np.asarray(s), np.asarray(d)
        return out
    return {**shallow, "layers": [
        jax.tree.map(lambda s, d, r=r: put(s, d, r), ts, td)
        for ts, td, r in zip(shallow["layers"], deep["layers"], rows)]}


def _jax_total_loss_fn(jcfg):
    lm = JaxLM(jcfg)
    return jax.jit(jax.value_and_grad(lambda p, t: sum(
        lm.loss(p, {"tokens": t[i]})[0] for i in range(t.shape[0]))))


def _train(arch, offload, params):
    tc = TrainConfig(model=get_reduced(arch),
                     shape=ShapeConfig("t", SEQ, M * MBB, "train"),
                     plan=_plan(offload),
                     optimizer=OptimizerConfig(**OCFG), seed=5)
    return train_pipeline(tc, P=P, device="cpu", steps=3, params=params,
                          data_source=SyntheticLM(tc.model.vocab_size, SEQ,
                                                  seed=5),
                          log=lambda s: None)


@pytest.mark.parametrize("arch", ARCHS)
def test_offload_trajectory_matches_composed_jax_oracle(arch):
    """3 steps of ``train_pipeline`` with the deep chunk offloaded against
    the composed oracle of the module docstring, same weights and
    batches: losses, first moments and masters (shallow, shared and
    deep) at the on-device trajectory test's bounds."""
    params = _bridged(arch)
    spec = make_pipeline_spec(get_reduced(arch), P=P, v=V, m=M,
                              microbatch=MBB, seq_len=SEQ,
                              schedule="chronos_zb")
    rows = _deep_rows(spec, params)
    assert all(r.any() and (~r).any() for r in rows)
    jp = jax.tree.map(jnp.asarray, tree_map(lambda a: a.numpy().copy(),
                                            unstage_params(params,
                                                           spec.layout)))
    out = _train(arch, True, params)

    vg = _jax_total_loss_fn(jax_get_reduced(arch))
    jocfg = JaxOptimizerConfig(**OCFG)
    j_sh, j_deep = _split_lm(jp, rows)
    jstate = jax_adamw_init(j_sh)
    host = JaxHostAdamW(jax.tree.map(np.asarray, j_deep), jocfg)
    jax_update = jax.jit(lambda g, s: jax_adamw_update(g, s, jocfg,
                                                       use_kernel=True))
    src = SyntheticLM(get_reduced(arch).vocab_size, SEQ, seed=5)
    jlosses = []
    for _ in range(3):
        toks = src.next_batch(M * MBB).reshape(M, MBB, SEQ)
        loss, g = vg(jp, toks)
        jlosses.append(float(loss) / M)
        g = jax.tree.map(lambda a: a.astype(jnp.float32) / M, g)
        g_sh, g_deep = _split_lm(g, rows)
        m_sh, jstate, _ = jax_update(g_sh, jstate)
        m_deep = host.update(jax.tree.map(np.asarray, g_deep))
        up = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16)
                          .astype(jnp.float32), m_deep)
        jp = jax.tree.map(jnp.asarray, _merge_lm(m_sh, up, rows))
    np.testing.assert_allclose(out["losses"], jlosses, rtol=0, atol=LOSS_TOL)
    assert out["losses"][-1] < out["losses"][0]
    rep = out["offload"]
    assert rep["submits"] == 3 and len(rep["host_update_s"]) == 3

    hopt = out["host_optimizer"]

    def ours(key):
        """The port's state in LM layout: shallow and shared from the
        device optimizer, the deep chunk from the host one."""
        st = out["opt_state"][key]
        deep = tree_map(torch.from_numpy, getattr(hopt, key))
        full = {**st, "blocks": merge_deep_shallow(st["blocks"], deep)}
        return tree_leaves(unstage_params(full, spec.layout))

    def ref(key):
        return jax.tree.leaves(_merge_lm(jstate[key], getattr(host, key),
                                         rows))

    def diffs(key):
        return np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel()
                               for a, b in zip(ours(key), ref(key))])
    d_mu, d_w = diffs("mu"), diffs("master")
    frac = float((d_w > W_TOL).mean())
    print(f"{arch} offload after 3 steps: losses {out['losses']}; max "
          f"|port - oracle| mu {d_mu.max():.3e}, master {d_w.max():.3e}; "
          f"master elements beyond {W_TOL:g}: {frac:.2e}")
    assert d_mu.max() <= MU_TOL
    assert frac <= W_FRAC and d_w.max() <= 2 * OCFG["lr"] * 3
    # the device holds each deep weight as its host master rounded to bf16
    _, deep_w = offload_kept(out["params"], _plan(True))
    for w, mst in zip(tree_leaves(deep_w), tree_leaves(hopt.master)):
        assert torch.equal(w, torch.from_numpy(mst).to(torch.bfloat16)
                           .to(w.dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_offload_matches_on_device_training(arch):
    """The port's offload run against its own on-device optimizer on the
    same weights and data, 3 steps: the step-1 losses equal, then within
    the reference's 5e-3."""
    base = _train(arch, False, _bridged(arch))
    off = _train(arch, True, _bridged(arch))
    diffs = [abs(a - b) for a, b in zip(base["losses"], off["losses"])]
    print(f"{arch}: on-device {base['losses']}, offload {off['losses']}, "
          f"max |d| {max(diffs):.3e}")
    assert base["losses"][0] == off["losses"][0]
    assert max(diffs) <= OFFLOAD_LOSS_TOL
    assert off["offload"]["submits"] == 3 and "offload" not in base
