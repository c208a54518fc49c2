"""The port's pipeline training step against the JAX package on the
reduced tinyllama (4 layers, d 128, fp32), P=2, m=4, two sequences of 17
tokens per microbatch — the sizes of ``tests/helpers/pipeline_check.py``.

The JAX side is the single-device oracle: ``jax.grad`` of ``LM.loss``
summed over the microbatches, and ``adamw_update(use_kernel=True)``
(Pallas interpret) for the trajectory.  Weights come from the JAX
package's ``init_pipeline_params`` and cross as numpy; token batches are
made with numpy from a seed and handed to both sides.

At bf16 the block gradients are held against the JAX package's own
pipeline executor, run in a child process with two host devices (this
file, run as a script, is that child)."""
import dataclasses
import os
import subprocess
import sys

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
from repro.core.pipeline_runtime import \
    make_pipeline_spec as jax_make_pipeline_spec
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
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
BF16_ARCHS = ("tinyllama-1.1b", "mamba2-2.7b")
# bf16 block gradients, port vs the JAX executor, per leaf max |d| / max
# |jax|: both sides run the forward and backward in bf16 in different op
# orders (measured on a CPU: 1.82e-2 tinyllama, 3.87e-2 mamba2; with the
# block gradients added in fp32 instead, 1.88e-2 and 3.98e-2, so this
# limit cannot tell the two accumulators apart); the loss, a mean of fp32
# CEs, to 1e-2
BF16_GRAD_TOL, BF16_LOSS_TOL = 6e-2, 1e-2

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


class MaskedSource:
    """``SyntheticLM`` tokens with a ``loss_mask`` aligned with them (as
    ``LM.loss`` reads it) that zeroes a ragged tail of each row, drawn
    from ``seed`` and the batch count."""

    def __init__(self, vocab, seq_len, seed):
        self.tokens = SyntheticLM(vocab, seq_len, seed=seed)
        self.seq_len, self.seed, self.n = seq_len, seed, 0

    def next_batch(self, batch):
        rng = np.random.default_rng((self.seed, self.n))
        self.n += 1
        keep = rng.integers(self.seq_len // 2, self.seq_len, (batch, 1))
        return {"tokens": self.tokens.next_batch(batch),
                "loss_mask": (np.arange(self.seq_len)[None] < keep
                              ).astype(np.float32)}

    def state(self):
        return {"tokens": self.tokens.state(), "n": self.n}

    def load_state(self, st):
        self.tokens.load_state(st["tokens"])
        self.n = st["n"]


def _jax_total_masked_loss(p, tokens, mask):
    lm = JaxLM(JCFG)
    return sum(lm.loss(p, {"tokens": tokens[i], "loss_mask": mask[i]})[0]
               for i in range(tokens.shape[0]))


_jax_masked_value_and_grad = jax.jit(jax.value_and_grad(
    _jax_total_masked_loss))


def _trajectory(schedule, kernels, source):
    """3 steps of ``train_pipeline`` on batches of ``source(seed)`` against
    ``jax.grad(LM.loss)`` / m and ``adamw_update(use_kernel=True)`` on the
    same batches (with their ``loss_mask`` where the source gives one)."""
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
                         data_source=source(5), log=lambda s: None)
    src = source(5)
    jstate = jax_adamw_init(jp)
    jax_update = jax.jit(lambda g, s: jax_adamw_update(
        g, s, JaxOptimizerConfig(**ocfg), use_kernel=True))
    jlosses = []
    for _ in range(3):
        b = src.next_batch(M * MBB)
        b = b if isinstance(b, dict) else {"tokens": b}
        toks = b["tokens"].reshape(M, MBB, SEQ)
        if "loss_mask" in b:
            loss, g = _jax_masked_value_and_grad(
                jp, toks, b["loss_mask"].reshape(M, MBB, SEQ))
        else:
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


@pytest.mark.parametrize("schedule,kernels", [("chronos_zb", "fused"),
                                              ("chronos", "plain")])
def test_train_pipeline_trajectory_matches_jax(schedule, kernels):
    """3 steps of ``train_pipeline`` against ``jax.grad(LM.loss)`` / m and
    ``adamw_update(use_kernel=True)`` on the same batches."""
    _trajectory(schedule, kernels,
                lambda seed: SyntheticLM(CFG.vocab_size, SEQ, seed=seed))


@pytest.mark.parametrize("schedule,kernels", [("chronos_zb", "fused"),
                                              ("chronos", "plain")])
def test_train_pipeline_passes_the_loss_mask(schedule, kernels):
    """A data source that emits a ``loss_mask``: every batch key reaches
    the step (the mask cut to the label positions, as ``LM.loss`` cuts
    it), against the masked ``jax.grad(LM.loss)`` trajectory."""
    _trajectory(schedule, kernels,
                lambda seed: MaskedSource(CFG.vocab_size, SEQ, seed))


def _mask(seed=3):
    """A loss mask over the label positions [M, MBB, SEQ - 1] that drops
    about 30% of them."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(M, MBB, SEQ - 1)) > 0.3).astype(np.float32)


@pytest.mark.parametrize("schedule", sorted(SCHEDULE_V))
def test_masked_pipeline_grads_match_jax_autodiff(schedule):
    """The executor with a ``loss_mask`` [m, mbB, S - 1] (the reference
    executor's layout) against ``jax.grad`` of the masked ``LM.loss``,
    which reads ``mask[:, 1:]`` of a token-aligned mask: the same mask
    behind a leading column of ones."""
    v = SCHEDULE_V[schedule]
    spec = make_pipeline_spec(CFG, P=P, v=v, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule=schedule,
                              kernels="fused")
    params = _jax_reference(v)[0]
    mask = _mask()
    grads, metrics = make_train_grads_fn(spec, "cpu")(
        params, {"tokens": torch.from_numpy(_tokens()),
                 "loss_mask": torch.from_numpy(mask)})
    full = np.concatenate([np.ones((M, MBB, 1), np.float32), mask], -1)
    loss, ref = _jax_masked_value_and_grad(
        _jax_tree(unstage_params(params, spec.layout)), _tokens(), full)
    ours = tree_leaves(unstage_params(grads, spec.layout))
    errs = [abs(float(metrics["loss"]) - float(loss) / M)] + [
        float(np.abs(a.numpy() - np.asarray(b)).max())
        for a, b in zip(ours, jax.tree.leaves(ref))]
    unmasked = _jax_reference(v)[1]
    print(f"{schedule} masked: loss {float(metrics['loss']):.6f} (unmasked "
          f"{unmasked:.6f}); max |port - jax.grad| = {max(errs):.3e}")
    assert abs(float(metrics["loss"]) - unmasked) > 1e-3   # the mask acts
    assert max(errs) <= GRAD_TOL


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
    """No silent CPU fallback; and offload must leave a shallow chunk on
    the device (the reference's assertion, here a ValueError)."""
    tc = TrainConfig(model=CFG, shape=ShapeConfig("t", SEQ, 8, "train"),
                     plan=ParallelPlan(microbatch_size=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_pipeline(tc, P=2, steps=1)
    off = dataclasses.replace(tc, plan=ParallelPlan(
        microbatch_size=2, num_chunks=2,
        offload=OffloadConfig(enabled=True, num_offload_chunks=2)))
    with pytest.raises(ValueError, match="at least one shallow chunk"):
        train_pipeline(off, P=2, device="cpu", steps=1)


# ---------------------------------------------------------------------------
# bf16: block gradients accumulate in the parameter dtype
# ---------------------------------------------------------------------------

def _bf16_setup(arch, schedule):
    """(port spec, JAX spec, port params, tokens) of the reduced ``arch``
    at bf16, P=2, v=2; the weights are the JAX ``init_pipeline_params``
    bits."""
    cfg = dataclasses.replace(get_reduced(arch), **BF16)
    jcfg = dataclasses.replace(jax_get_reduced(arch), **BF16)
    kw = dict(P=P, v=2, m=M, microbatch=MBB, seq_len=SEQ, schedule=schedule)
    jspec = jax_make_pipeline_spec(jcfg, kernels="xla", **kw)
    jparams, _ = jax_init_pipeline_params(jax.random.key(0), jcfg,
                                          jspec.layout)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (M, MBB, SEQ)).astype(np.int32)
    spec = make_pipeline_spec(cfg, kernels="plain", **kw)
    return spec, jspec, jparams, params, tokens


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_block_grad_accumulators_take_the_parameter_dtype(arch):
    """At bf16 every block gradient comes back in its parameter leaf's
    dtype, as the reference's ``jax.tree.map(jnp.zeros_like, blocks)``
    accumulators (``src/repro/core/pipeline_runtime.py:690``, ``:1396``),
    and every shared gradient in fp32 (``:691-692``, ``:1392-1393``).  A
    Mamba-2 block mixes fp32 leaves (``A_log``, ``D``, ``dt_bias``) with
    bf16 ones.  chronos_zb runs the split backward (B and W ops) and the
    fused one at the pipeline's first block."""
    spec, _, jparams, params, tokens = _bf16_setup(arch, "chronos_zb")
    grads, _ = make_train_grads_fn(spec, "cpu")(
        params, {"tokens": torch.from_numpy(tokens)})
    want = [str(a.dtype) for a in jax.tree.leaves(
        jax.tree.map(jnp.zeros_like, jparams["blocks"]))]
    got = [str(g.dtype).removeprefix("torch.")
           for g in tree_leaves(grads["blocks"])]
    assert got == want and "bfloat16" in got
    assert ("float32" in got) == (arch == "mamba2-2.7b")
    shared = [g for k in ("embed", "final_norm")
              for g in tree_leaves(grads[k])]
    assert shared and all(g.dtype == torch.float32 for g in shared)


@pytest.fixture(scope="module")
def jax_bf16_grads(tmp_path_factory):
    """The JAX executor's bf16 gradients and losses for every arch of
    ``BF16_ARCHS``, from one child process with two host devices."""
    out = tmp_path_factory.mktemp("bf16") / "jax_grads.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, __file__, str(out), *BF16_ARCHS],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_pipeline_grads_match_jax_executor(arch, jax_bf16_grads):
    """chronos at bf16 (the schedule of the reference's bitwise recomp
    pair): the port's loss and its block and shared gradients against
    the JAX pipeline executor's (``kernels="xla"``, the legacy per-tick
    executor: on this JAX version the phase executor stops at its
    loss-head ``lax.cond`` at bf16), same weights and tokens.  This checks
    agreement only: the bf16 forward and backward differ more between the
    two than bf16 and fp32 accumulation do, so the accumulators' dtype is
    held by ``test_block_grad_accumulators_take_the_parameter_dtype``."""
    spec, _, _, params, tokens = _bf16_setup(arch, "chronos")
    grads, met = make_train_grads_fn(spec, "cpu")(
        params, {"tokens": torch.from_numpy(tokens)})
    ours = tree_leaves(grads["blocks"]) + [
        g for k in ("embed", "final_norm") for g in tree_leaves(grads[k])]
    errs = []
    for i, g in enumerate(ours):
        ref = jax_bf16_grads[f"{arch}/{i}"]
        assert ref.shape == tuple(g.shape)
        errs.append(float(np.abs(g.float().numpy() - ref).max()
                          / (np.abs(ref).max() + 1e-12)))
    e_loss = abs(float(met["loss"]) - float(jax_bf16_grads[f"{arch}/loss"]))
    print(f"{arch} bf16: loss |d| {e_loss:.2e}; per-leaf max|d| / max|jax| "
          f"{max(errs):.2e}")
    assert e_loss <= BF16_LOSS_TOL
    assert max(errs) <= BF16_GRAD_TOL


def _jax_bf16_grads_child(out, archs):
    """Run as a script: the JAX pipeline executor's chronos gradients at
    bf16 for ``archs``, block leaves then embed and final_norm, as fp32
    arrays in ``out`` (bf16 widens to fp32 exactly)."""
    from repro.core.pipeline_runtime import \
        make_train_grads_fn as jax_make_train_grads_fn
    from repro.jax_compat import make_mesh
    from repro.models import shard_env
    mesh = make_mesh((P,), ("pp",))
    res = {}
    for arch in archs:
        _, jspec, jparams, _, tokens = _bf16_setup(arch, "chronos")
        fn = jax.jit(jax_make_train_grads_fn(jspec, mesh, executor="legacy"))
        with shard_env(mesh, {}):
            g, met = fn(jparams, {"tokens": jnp.asarray(tokens)})
        leaves = jax.tree.leaves(g["blocks"]) + [
            a for k in ("embed", "final_norm") for a in jax.tree.leaves(g[k])]
        for i, a in enumerate(leaves):
            res[f"{arch}/{i}"] = np.asarray(a).astype(np.float32)
        res[f"{arch}/loss"] = np.float32(met["loss"])
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_bf16_grads_child(sys.argv[1], sys.argv[2:])
