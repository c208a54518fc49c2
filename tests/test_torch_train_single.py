"""The port's single-device ``train()`` against the JAX ``train()`` on the
reduced tinyllama and mamba2 (fp32, CPU): 3 steps from the same weights
(the JAX ``LM.init(key(seed))`` bridged) and the same batches, for the
recompute modes ``none``, ``chronos`` and ``full``, and with a loss mask.
The JAX run's final optimizer state is read back from its checkpoint.
Also: ``plan_schedule_kwargs`` against the reference's for every
registered schedule and recompute mode, and uniform recompute in the
pipeline executor (1F1B+R), which only retimes the table."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import get_reduced as jax_get_reduced
from repro.ft import Checkpointer as JaxCheckpointer
from repro.launch import steps as jax_steps
from repro.launch import train as jax_train_module
from repro.models import LM as JaxLM
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import base as TB
from repro_torch.configs import get_reduced
from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                               make_pipeline_spec,
                                               make_train_grads_fn)
from repro_torch.core.schedules import REGISTRY
from repro_torch.data import DataPipeline, SyntheticLM
from repro_torch.launch.steps import plan_schedule_kwargs
from repro_torch.launch.train import train, train_pipeline
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOSS_TOL = 1e-5           # test_torch_train.py's trajectory bounds
MU_TOL = 1e-6
W_TOL, W_FRAC = 1e-6, 1e-3


def _cfgs(arch):
    return get_reduced(arch), jax_get_reduced(arch)


# ---------------------------------------------------------------------------
# train() against the JAX train()
# ---------------------------------------------------------------------------

TRAIN_SEQ, GLOBAL_BATCH, MICROBATCH = 32, 4, 2   # JAX SyntheticLM: even S
OCFG = dict(warmup_steps=1, total_steps=3, lr=1e-3)


class MaskedSource:
    """``SyntheticLM`` tokens with a ``loss_mask`` that zeroes a ragged
    tail of each row, drawn from ``seed`` and the batch count."""

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


def _train_pair(arch, mode, tmp_path, masked=False, monkeypatch=None):
    """(the port's ``train`` output, the JAX ``train`` output, its final
    params and optimizer state) over 3 steps, both from the JAX
    ``LM.init(key(seed))`` weights and the same batches."""
    seed = 5
    cfg, jcfg = _cfgs(arch)
    shape = dict(name="t", seq_len=TRAIN_SEQ, global_batch=GLOBAL_BATCH,
                 kind="train")
    jtc = JB.TrainConfig(
        model=jcfg, shape=JB.ShapeConfig(**shape),
        plan=JB.ParallelPlan(num_chunks=2, microbatch_size=MICROBATCH,
                             recompute=JB.RecomputeConfig(mode=mode)),
        optimizer=JB.OptimizerConfig(**OCFG), seed=seed, log_every=1,
        checkpoint_dir=str(tmp_path))
    src = (lambda: MaskedSource(cfg.vocab_size, TRAIN_SEQ, seed)) \
        if masked else (lambda: None)
    if masked:      # the reference's pipeline passes only the tokens on
        monkeypatch.setattr(jax_train_module, "DataPipeline", DataPipeline)
    jout = jax_train_module.train(jtc, steps=3, data_source=src(),
                                  log=lambda s: None)
    jp, _ = JaxLM(jcfg).init(jax.random.key(seed))
    restored, extra = JaxCheckpointer(str(tmp_path)).restore(
        {"params": jp, "opt": jax_adamw_init(jp)})
    assert extra["step"] == 3
    tc = TB.TrainConfig(
        model=cfg, shape=TB.ShapeConfig(**shape),
        plan=TB.ParallelPlan(num_chunks=2, microbatch_size=MICROBATCH,
                             recompute=TB.RecomputeConfig(mode=mode),
                             kernels="fused"),
        optimizer=TB.OptimizerConfig(**OCFG), seed=seed, log_every=1)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    out = train(tc, device="cpu", steps=3, params=params,
                data_source=src(), log=lambda s: None)
    return out, jout, restored


def _assert_trajectory(out, jout, restored):
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=0,
                               atol=LOSS_TOL)

    def diffs(key):
        return np.concatenate([
            np.abs(a.numpy() - np.asarray(b)).ravel() for a, b in zip(
                tree_leaves(out["opt_state"][key]),
                jax.tree.leaves(restored["opt"][key]))])
    d_mu, d_w = diffs("mu"), diffs("master")
    frac = float((d_w > W_TOL).mean())
    print(f"after 3 steps: max |port - jax| mu {d_mu.max():.3e}, master "
          f"{d_w.max():.3e}; master elements beyond {W_TOL:g}: {frac:.2e}")
    assert d_mu.max() <= MU_TOL
    assert frac <= W_FRAC and d_w.max() <= 2 * OCFG["lr"] * 3
    assert out["steps"] == jout["steps"] == 3
    assert len(out["grad_norms"]) == len(out["lrs"]) == 3
    # the weights are the masters rounded (fp32 here: the masters)
    for w, m in zip(tree_leaves(out["params"]),
                    tree_leaves(out["opt_state"]["master"])):
        assert torch.equal(w, m)


@pytest.mark.parametrize("mode", ["none", "chronos", "full"])
def test_train_matches_jax_train(mode, tmp_path):
    out, jout, restored = _train_pair("tinyllama-1.1b", mode, tmp_path)
    _assert_trajectory(out, jout, restored)
    assert out["losses"][-1] < out["losses"][0]


def test_train_mamba2_matches_jax_train(tmp_path):
    _assert_trajectory(*_train_pair("mamba2-2.7b", "chronos", tmp_path))


def test_masked_train_matches_jax_train(tmp_path, monkeypatch):
    out, jout, restored = _train_pair("tinyllama-1.1b", "chronos", tmp_path,
                                      masked=True, monkeypatch=monkeypatch)
    _assert_trajectory(out, jout, restored)
    plain, _, _ = _train_pair("tinyllama-1.1b", "chronos",
                              tmp_path / "unmasked")
    assert abs(out["losses"][0] - plain["losses"][0]) > 1e-4


def test_train_refuses_cuda_without_a_card(monkeypatch):
    cfg = get_reduced("tinyllama-1.1b")
    tc = TB.TrainConfig(model=cfg,
                        shape=TB.ShapeConfig("t", TRAIN_SEQ, 4, "train"),
                        plan=TB.ParallelPlan(microbatch_size=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train(tc, steps=1)


# ---------------------------------------------------------------------------
# plan_schedule_kwargs; uniform recompute in the pipeline executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "chronos", "uniform", "full"])
@pytest.mark.parametrize("schedule", sorted(REGISTRY))
def test_plan_schedule_kwargs_are_the_reference(schedule, mode):
    for v, rc_kw in ((2, {}), (3, dict(num_recomp_chunks=2)),
                     (2, dict(uniform_frac=0.0)), (3, dict(policy="x"))):
        ours = plan_schedule_kwargs(TB.ParallelPlan(
            schedule=schedule, num_chunks=v,
            recompute=TB.RecomputeConfig(mode=mode, **rc_kw)))
        ref = jax_steps.plan_schedule_kwargs(JB.ParallelPlan(
            schedule=schedule, num_chunks=v,
            recompute=JB.RecomputeConfig(mode=mode, **rc_kw)))
        assert ours == ref, (v, rc_kw)


def test_uniform_recompute_1f1b_equals_1f1b_bitwise():
    """1F1B+R only retimes the table: losses, gradients and the trained
    weights equal plain 1F1B's bitwise."""
    cfg = get_reduced("tinyllama-1.1b")
    P, m, mbB, seq = 2, 4, 2, 17
    plans = {rc: TB.ParallelPlan(schedule="1f1b", num_chunks=1,
                                 microbatch_size=mbB, num_microbatches=m,
                                 recompute=TB.RecomputeConfig(rc))
             for rc in ("none", "uniform")}
    assert plan_schedule_kwargs(plans["uniform"]) == {"recomp": 0.5}
    specs = {rc: make_pipeline_spec(cfg, P=P, v=1, m=m, microbatch=mbB,
                                    seq_len=seq, schedule="1f1b",
                                    **plan_schedule_kwargs(plan))
             for rc, plan in plans.items()}
    assert specs["uniform"].table.name != specs["none"].table.name
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (m, mbB, seq)).astype(np.int32))
    params = init_pipeline_params(torch.Generator().manual_seed(0), cfg,
                                  specs["none"].layout, "cpu")
    res = {rc: make_train_grads_fn(spec, "cpu")(params, {"tokens": tokens})
           for rc, spec in specs.items()}
    assert float(res["none"][1]["loss"]) == float(res["uniform"][1]["loss"])
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(res["none"][0]), tree_leaves(res["uniform"][0])))
    outs = {}
    for rc, plan in plans.items():
        tc = TB.TrainConfig(model=cfg,
                            shape=TB.ShapeConfig("t", seq, m * mbB, "train"),
                            plan=plan,
                            optimizer=TB.OptimizerConfig(**OCFG), seed=3)
        outs[rc] = train_pipeline(tc, P=P, device="cpu", steps=2,
                                  params=tree_map(torch.clone, params),
                                  log=lambda s: None)
    assert outs["none"]["losses"] == outs["uniform"]["losses"]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(outs["none"]["params"]),
        tree_leaves(outs["uniform"]["params"])))
