"""The port's pipeline training step against the JAX package on the
reduced tinyllama (4 layers, d 128, fp32), P=2, m=4, two sequences of 17
tokens per microbatch — the sizes of ``tests/helpers/pipeline_check.py``.

The JAX side is the single-device oracle: ``jax.grad`` of ``LM.loss``
summed over the microbatches, and ``adamw_update(use_kernel=True)``
(Pallas interpret) for the trajectory.  Weights come from the JAX
package's ``init_pipeline_params`` and cross as numpy; token batches are
made with numpy from a seed and handed to both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import LM as JaxLM
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.configs.base import (OffloadConfig, OptimizerConfig,
                                      ParallelPlan, ShapeConfig, TrainConfig)
from repro_torch.core.pipeline_runtime import (make_pipeline_spec,
                                               make_train_grads_fn,
                                               unstage_params)
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import train_pipeline
from repro_torch.tree import tree_leaves, tree_map

P, M, MBB, SEQ = 2, 4, 2, 17
GRAD_TOL = 5e-3           # pipeline vs single-device autodiff (JAX's bound)
PAIR_TOL = 1e-5           # split vs fused backward: accumulation order only
LOSS_TOL = 1e-5           # per-step loss, port vs JAX (atol)
MU_TOL = 1e-6             # first moment after 3 steps: summed gradients
# Adam divides mu by sqrt(nu): where a gradient element sits at the
# rounding noise of its sums (|mu| ~ sqrt(nu) ~ 1e-5..1e-4 after a
# cancellation) the two sides' normalised steps may differ by up to
# 2 * lr per step.  So most weights agree to 1e-6 and every weight lies
# within that hard bound.
W_TOL, W_FRAC = 1e-6, 1e-3
SCHEDULE_V = {"chronos": 2, "chronos_zb": 2, "chronos_recomp": 2,
              "1f1b": 1, "zb_h1": 1}

CFG = get_reduced("tinyllama-1.1b")
JCFG = jax_get_reduced("tinyllama-1.1b")


def _tokens(seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, (M, MBB, SEQ)).astype(np.int32)


def _bridged(v):
    """JAX ``init_pipeline_params`` weights at (P, v), as a torch tree."""
    params, _ = jax_init_pipeline_params(
        jax.random.key(0), JCFG, JaxStageLayout.build(JCFG, P, v))
    return lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def _jax_tree(tree):
    """A JAX copy of a torch tree (the port writes weights in place)."""
    return jax.tree.map(jnp.asarray,
                        tree_map(lambda a: a.numpy().copy(), tree))


def _jax_total_loss(p, tokens):
    lm = JaxLM(JCFG)
    return sum(lm.loss(p, {"tokens": tokens[i]})[0]
               for i in range(tokens.shape[0]))


# one compile serves every call: the LM-layout tree has the same shapes
# for v = 1 and v = 2
_jax_value_and_grad = jax.jit(jax.value_and_grad(_jax_total_loss))


_REF = {}


def _jax_reference(v):
    """(weights, loss, grads) of the single-device oracle at (P, v), in
    ``LM`` layout; computed once per v."""
    if v not in _REF:
        params = _bridged(v)
        spec = make_pipeline_spec(CFG, P=P, v=v, m=M, microbatch=MBB,
                                  seq_len=SEQ, schedule="chronos" if v == 2
                                  else "1f1b")
        lm_p = _jax_tree(unstage_params(params, spec.layout))
        loss, grads = _jax_value_and_grad(lm_p, _tokens())
        _REF[v] = (params, float(loss) / M, jax.tree.leaves(grads))
    return _REF[v]


def _run(schedule, kernels="plain", params=None):
    v = SCHEDULE_V[schedule]
    spec = make_pipeline_spec(CFG, P=P, v=v, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule=schedule,
                              kernels=kernels)
    if params is None:
        params = _jax_reference(v)[0]
    grads, metrics = make_train_grads_fn(spec, "cpu")(
        params, {"tokens": torch.from_numpy(_tokens())})
    return spec, grads, metrics


@pytest.mark.parametrize("schedule", sorted(SCHEDULE_V))
def test_pipeline_grads_match_jax_autodiff(schedule):
    spec, grads, metrics = _run(schedule, kernels="fused")
    _, ref_loss, ref_grads = _jax_reference(SCHEDULE_V[schedule])
    ours = tree_leaves(unstage_params(grads, spec.layout))
    assert len(ours) == len(ref_grads)
    errs = [abs(float(metrics["loss"]) - ref_loss)] + [
        float(np.abs(a.numpy() - np.asarray(b)).max())
        for a, b in zip(ours, ref_grads)]
    print(f"{schedule}: max |port - jax.grad| = {max(errs):.3e}")
    assert max(errs) <= GRAD_TOL
    assert metrics["n_microbatches"] == M


@pytest.mark.parametrize("kernels", ["plain", "fused"])
def test_chronos_recomp_equals_chronos_bitwise(kernels):
    _, a, ma = _run("chronos_recomp", kernels)
    _, b, mb = _run("chronos", kernels)
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("split,fused", [("zb_h1", "1f1b"),
                                         ("chronos_zb", "chronos")])
def test_split_backward_matches_fused_backward(split, fused):
    _, a, _ = _run(split)
    _, b, _ = _run(fused)
    worst = max(float((x - y).abs().max())
                for x, y in zip(tree_leaves(a), tree_leaves(b)))
    print(f"{split} vs {fused}: max |d| = {worst:.3e}")
    assert worst <= PAIR_TOL


@pytest.mark.parametrize("schedule", ["chronos_zb", "chronos_recomp"])
def test_rings_are_the_table_depths(schedule):
    spec = make_pipeline_spec(CFG, P=P, v=2, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule=schedule)
    tab = spec.table
    rings = make_train_grads_fn(spec, "cpu").rings
    payload = (MBB, SEQ - 1, CFG.d_model)
    for d in range(P):
        assert tuple(rings["fq"][d].shape) == (tab.fq_depth,) + payload
        assert tuple(rings["bq"][d].shape) == (tab.bq_depth,) + payload
        for name, depths in (("act", tab.act_depth), ("rmt", tab.rmt_depth),
                             ("wx", tab.wstash_depth),
                             ("wdy", tab.wstash_depth)):
            assert {c: tuple(a.shape) for c, a in rings[name][d].items()} \
                == {c: (k,) + payload for c, k in depths.items()}, name
    assert bool(tab.wstash_depth) == (schedule == "chronos_zb")
    assert bool(tab.rmt_depth) == (schedule == "chronos_recomp")
    assert all(r.dtype == torch.float32 for r in rings["fq"])


@pytest.mark.parametrize("schedule,kernels", [("chronos_zb", "fused"),
                                              ("chronos", "plain")])
def test_train_pipeline_trajectory_matches_jax(schedule, kernels):
    """3 steps of ``train_pipeline`` against ``jax.grad(LM.loss)`` / m and
    ``adamw_update(use_kernel=True)`` on the same batches."""
    v = SCHEDULE_V[schedule]
    ocfg = dict(warmup_steps=1, total_steps=3, lr=1e-3)
    tc = TrainConfig(model=CFG, shape=ShapeConfig("t", SEQ, M * MBB, "train"),
                     plan=ParallelPlan(schedule=schedule, num_chunks=v,
                                       microbatch_size=MBB,
                                       num_microbatches=M, kernels=kernels),
                     optimizer=OptimizerConfig(**ocfg), seed=5)
    params = tree_map(torch.clone, _jax_reference(v)[0])
    spec = make_pipeline_spec(CFG, P=P, v=v, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule=schedule)
    jp = _jax_tree(unstage_params(params, spec.layout))
    out = train_pipeline(tc, P=P, device="cpu", steps=3, params=params,
                         data_source=SyntheticLM(CFG.vocab_size, SEQ, seed=5),
                         log=lambda s: None)
    src = SyntheticLM(CFG.vocab_size, SEQ, seed=5)
    jstate = jax_adamw_init(jp)
    jax_update = jax.jit(lambda g, s: jax_adamw_update(
        g, s, JaxOptimizerConfig(**ocfg), use_kernel=True))
    jlosses = []
    for _ in range(3):
        toks = src.next_batch(M * MBB).reshape(M, MBB, SEQ)
        loss, g = _jax_value_and_grad(jp, toks)
        jlosses.append(float(loss) / M)
        g = jax.tree.map(lambda a: a.astype(jnp.float32) / M, g)
        jm, jstate, _ = jax_update(g, jstate)
        jp = jax.tree.map(lambda m, p: m.astype(p.dtype), jm, jp)
    np.testing.assert_allclose(out["losses"], jlosses, rtol=0, atol=LOSS_TOL)
    assert out["losses"][-1] < out["losses"][0]

    def diffs(key):
        ours = tree_leaves(unstage_params(out["opt_state"][key], spec.layout))
        return np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel()
                               for a, b in zip(ours,
                                               jax.tree.leaves(jstate[key]))])
    d_mu, d_w = diffs("mu"), diffs("master")
    frac = float((d_w > W_TOL).mean())
    print(f"{schedule}/{kernels} after 3 steps: max |port - jax| mu "
          f"{d_mu.max():.3e}, master {d_w.max():.3e}; master elements "
          f"beyond {W_TOL:g}: {frac:.2e}")
    assert d_mu.max() <= MU_TOL
    assert frac <= W_FRAC and d_w.max() <= 2 * ocfg["lr"] * 3
    assert out["steps"] == 3 and out["schedule"] == spec.table.name


@pytest.mark.parametrize("seq_len", [16, 64])
def test_synthetic_batches_equal_jax(seq_len):
    ours, ref = SyntheticLM(512, seq_len, seed=3), JaxSyntheticLM(
        512, seq_len, seed=3)
    for n in (4, 3):
        np.testing.assert_array_equal(ours.next_batch(n), ref.next_batch(n))
    assert ours.state() == ref.state()


def test_synthetic_odd_length_is_the_even_stream_cut():
    """The reference raises for an odd seq_len; the port's stream is the
    next even length's stream without its last token."""
    ours = SyntheticLM(512, SEQ, seed=3).next_batch(4)
    ref = JaxSyntheticLM(512, SEQ + 1, seed=3).next_batch(4)
    np.testing.assert_array_equal(ours, ref[:, :SEQ])


def test_train_pipeline_refuses_cuda_without_a_card_and_offload(
        monkeypatch):
    tc = TrainConfig(model=CFG, shape=ShapeConfig("t", SEQ, 8, "train"),
                     plan=ParallelPlan(microbatch_size=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_pipeline(tc, P=2, steps=1)
    off = dataclasses.replace(tc, plan=ParallelPlan(
        microbatch_size=2, offload=OffloadConfig(enabled=True)))
    with pytest.raises(NotImplementedError, match="Offload"):
        train_pipeline(off, P=2, device="cpu", steps=1)
