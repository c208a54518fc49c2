"""The port's V-shape family against the JAX package: the fold-back
placement, and pipeline gradients of ``v_min``, ``v_half`` and ``v_zb``
on the reduced tinyllama (4 layers, d 128, fp32), P=2, m=4, two
sequences of 17 tokens per microbatch, against ``jax.grad`` of the JAX
``LM.loss`` (the reference's V-shape executor is no oracle on this JAX
version).  Weights come from the JAX package's ``init_pipeline_params``
under the V-shape layout and cross as numpy; tokens and the loss mask
are made with numpy from a seed.  (The generators' schedules and tables
are pinned in ``tests/test_torch_schedules.py``.)"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.core.placement import get_placement as jax_get_placement
from repro.models import LM as JaxLM
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.configs.base import (OptimizerConfig, ParallelPlan,
                                      ShapeConfig, TrainConfig)
from repro_torch.core.pipeline_runtime import (make_pipeline_spec,
                                               make_train_grads_fn,
                                               restage_params,
                                               unstage_params)
from repro_torch.core.placement import VShapePlacement, get_placement
from repro_torch.core.tasktable import SEND_F_LOC, SEND_F_UP
from repro_torch.launch.train import train_pipeline
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

P, M, MBB, SEQ = 2, 4, 2, 17
VSHAPE = ("v_min", "v_half", "v_zb")
# pipeline vs single-device autodiff in fp32: the same products in
# another summation order (read 4.8e-7 on a CPU)
GRAD_TOL = 1e-5

CFG = get_reduced("tinyllama-1.1b")
JCFG = jax_get_reduced("tinyllama-1.1b")


def _tokens(seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, (M, MBB, SEQ)).astype(np.int32)


def _mask(seed=3):
    """A loss mask over the label positions [M, MBB, SEQ - 1]."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(M, MBB, SEQ - 1)) > 0.3).astype(np.float32)


def _bridged():
    """JAX ``init_pipeline_params`` weights under the V-shape layout."""
    lay = JaxStageLayout.build(JCFG, P, 2,
                               placement=jax_get_placement("vshape", P, 2))
    params, _ = jax_init_pipeline_params(jax.random.key(0), JCFG, lay)
    return lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray,
                        tree_map(lambda a: a.numpy().copy(), tree))


def _jax_total_loss(p, tokens, mask):
    lm = JaxLM(JCFG)
    return sum(lm.loss(p, {"tokens": tokens[i], "loss_mask": mask[i]})[0]
               for i in range(tokens.shape[0]))


_jax_value_and_grad = jax.jit(jax.value_and_grad(_jax_total_loss))


@pytest.mark.parametrize("P_", [2, 3, 4])
def test_vshape_placement_matches_jax(P_):
    ours, ref = get_placement("vshape", P_, 2), jax_get_placement(
        "vshape", P_, 2)
    assert isinstance(ours, VShapePlacement) and ours.name == ref.name
    assert ours.describe() == ref.describe()
    for d in range(P_):
        for c in range(2):
            assert (ours.device(d, c), ours.stage(d, c), ours.block(d, c)) \
                == (ref.device(d, c), ref.stage(d, c), ref.block(d, c))
    # device d holds blocks d and 2P-1-d
    assert [sorted(ours.block(d, c) for c in range(2))
            for d in range(P_)] == [[d, 2 * P_ - 1 - d] for d in range(P_)]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("schedule", VSHAPE)
def test_vshape_grads_match_jax_autodiff(schedule, masked):
    """Pipeline loss and gradients against ``jax.grad`` of the JAX
    ``LM.loss`` summed over the microbatches (the mask: behind a leading
    column of ones, as ``LM.loss`` reads a token-aligned mask)."""
    spec = make_pipeline_spec(CFG, P=P, v=2, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule=schedule,
                              kernels="fused")
    assert spec.layout.pl.name == "vshape" and spec.table.has_w
    codes = set(np.unique(spec.table.send).tolist())
    assert {SEND_F_UP, SEND_F_LOC} <= codes      # the V routes ran
    params = _bridged()
    mask = _mask() if masked else np.ones((M, MBB, SEQ - 1), np.float32)
    batch = {"tokens": torch.from_numpy(_tokens())}
    if masked:
        batch["loss_mask"] = torch.from_numpy(mask)
    grads, metrics = make_train_grads_fn(spec, "cpu")(params, batch)
    full = np.concatenate([np.ones((M, MBB, 1), np.float32), mask], -1)
    loss, ref = _jax_value_and_grad(
        _jax_tree(unstage_params(params, spec.layout)), _tokens(), full)
    ours = tree_leaves(unstage_params(grads, spec.layout))
    errs = [abs(float(metrics["loss"]) - float(loss) / M)] + [
        float(np.abs(a.numpy() - np.asarray(b)).max())
        for a, b in zip(ours, jax.tree.leaves(ref))]
    print(f"{schedule} {'masked' if masked else 'unmasked'}: max |port - "
          f"jax.grad| = {max(errs):.3e}")
    assert len(ours) == len(jax.tree.leaves(ref))
    assert max(errs) <= GRAD_TOL
    assert metrics["n_microbatches"] == M


def test_vmin_matches_interleaved_chronos():
    """The same network under the fold-back and under the interleaved
    striping (weights remapped by layer block): v_min's gradients equal
    chronos (v=2)'s up to summation order."""
    params = _bridged()
    batch = {"tokens": torch.from_numpy(_tokens())}
    kw = dict(P=P, v=2, m=M, microbatch=MBB, seq_len=SEQ, kernels="fused")
    vs, ch = (make_pipeline_spec(CFG, schedule=s, **kw)
              for s in ("v_min", "chronos"))
    g_v, m_v = make_train_grads_fn(vs, "cpu")(params, batch)
    g_c, m_c = make_train_grads_fn(ch, "cpu")(
        restage_params(params, vs.layout, ch.layout), batch)
    a = tree_leaves(unstage_params(g_v, vs.layout))
    b = tree_leaves(unstage_params(g_c, ch.layout))
    err = max(float((x - y).abs().max()) for x, y in zip(a, b))
    print(f"v_min vs chronos: max |d| = {err:.3e}")
    assert abs(float(m_v["loss"]) - float(m_c["loss"])) <= GRAD_TOL
    assert err <= GRAD_TOL


def test_train_pipeline_vmin_takes_steps_and_refuses_v1():
    """``train_pipeline`` with v_min (fused AdamW: the table has W
    tasks) takes 2 steps whose losses fall; v_min with num_chunks=1 is
    the reference's assertion, a ValueError here."""
    plan = ParallelPlan(schedule="v_min", num_chunks=2, microbatch_size=MBB,
                        num_microbatches=M, kernels="fused")
    tc = TrainConfig(model=CFG, shape=ShapeConfig("t", SEQ, M * MBB, "train"),
                     plan=plan, optimizer=OptimizerConfig(
                         warmup_steps=1, total_steps=2, lr=1e-3), seed=5)
    out = train_pipeline(tc, P=P, device="cpu", steps=2, params=_bridged(),
                         log=lambda s: None)
    assert out["steps"] == 2 and out["losses"][1] < out["losses"][0]
    assert out["schedule"] == "v-min(P=2)"
    bad = dataclasses.replace(tc, plan=dataclasses.replace(plan,
                                                           num_chunks=1))
    with pytest.raises(ValueError, match="fixed v=2"):
        train_pipeline(bad, P=P, device="cpu", steps=1)
