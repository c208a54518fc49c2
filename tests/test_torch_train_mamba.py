"""The port's mamba2 path — ``LM`` with Mamba-2 layers, the pipeline
training step, AdamW over its fp32 leaves, greedy serving streams of
``LM`` — against the JAX package on the reduced mamba2 (4 layers, d 128,
state 16, head dim 32, chunk 16, fp32, tied embeddings).

The JAX side is ``LM.loss`` under ``jax.grad`` and ``LM.prefill_chunk`` /
``decode_step``; the pipeline executor is held against the port's own
``LM.loss`` (the JAX fused pipeline executor is not an oracle on this
JAX version).  Weights come from the JAX ``LM.init`` with the per-head
leaves and norm scales redrawn, so no gradient is trivially zero, and
cross as numpy; token batches are made with numpy from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.core.pipeline_runtime import \
    pipeline_period as jax_pipeline_period
from repro.models import LM as JaxLM
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import (OptimizerConfig, ParallelPlan,
                                      ShapeConfig, TrainConfig)
from repro_torch.core.layout import pipeline_period
from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                               make_pipeline_spec,
                                               make_train_grads_fn,
                                               unstage_params)
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import train_pipeline
from repro_torch.models import LM
from repro_torch.serve import PipelinedEngine
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "mamba2-2.7b"
CFG = get_reduced(ARCH)
JCFG = jax_get_reduced(ARCH)
P, V, M, MBB = 2, 2, 4, 1
SEQ = 41                  # 40 positions: two SSD chunks of 16 and 8 more
LOSS_TOL = 1e-5           # LM.loss, port vs JAX
GRAD_TOL = 1e-5           # its gradients (measured ~4e-7)
PIPE_TOL = 1e-5           # pipeline vs the port's LM.loss (~2e-7)
LOGIT_TOL = 2e-5          # serving logits, port vs JAX (~3e-6)


def _tokens(shape, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, shape).astype(np.int32)


def _redraw(tree, seed):
    """A_log, D, dt_bias and the norm scales of a numpy LM / pipeline
    tree redrawn from ``seed`` (in place)."""
    rng = np.random.default_rng(seed)
    ranges = {"A_log": (-0.5, 0.5), "D": (0.5, 1.5),
              "dt_bias": (-3.0, -1.0), "scale": (0.5, 1.5),
              "norm_scale": (0.5, 1.5)}

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, list):
                for u in v:
                    walk(u)
            elif k in ranges:
                t[k] = rng.uniform(*ranges[k], v.shape).astype(v.dtype)
    walk(tree)
    return tree


def _jax_lm_params(seed=0):
    params, _ = JaxLM(JCFG).init(jax.random.key(seed))
    return _redraw(jax.tree.map(np.asarray, params), seed + 10)


def _jax_loss_and_grads(np_params, tokens):
    lm = JaxLM(JCFG)
    p = jax.tree.map(jnp.asarray, np_params)
    loss, g = jax.value_and_grad(
        lambda p_: lm.loss(p_, {"tokens": jnp.asarray(tokens)})[0])(p)
    return float(loss), jax.tree.leaves(g)


def _err(a, b):
    return float(np.abs(a.detach().numpy() - np.asarray(b)).max())


@pytest.mark.parametrize("kernels", ["fused", "plain"])
def test_lm_loss_and_grads_match_jax(kernels):
    """Bridged weights: the port's ``LM.loss`` and every gradient against
    JAX ``LM.loss`` under ``jax.grad``."""
    np_params = _jax_lm_params()
    toks = _tokens((2, SEQ))
    ref_loss, ref_g = _jax_loss_and_grads(np_params, toks)
    params = tree_map(lambda a: a.requires_grad_(),
                      lm_params_from_numpy(np_params, "cpu"))
    loss, _ = LM(CFG, kernels=kernels, device="cpu").loss(
        params, {"tokens": torch.from_numpy(toks)})
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    assert len(grads) == len(ref_g) == 16
    e_l = abs(loss.item() - ref_loss)
    e_g = max(_err(a, b) for a, b in zip(grads, ref_g))
    print(f"{kernels}: loss {loss.item():.6f} vs {ref_loss:.6f} "
          f"(|d| {e_l:.2e}), grads max |d| {e_g:.2e}")
    assert e_l <= LOSS_TOL and e_g <= GRAD_TOL


_PIPE = {}


def _pipeline_vs_lm(schedule):
    """(pipeline grads and loss, LM.loss's gradient leaves and loss,
    spec) for the
    port's own reduced-mamba2 weights, computed once per schedule."""
    if schedule not in _PIPE:
        spec = make_pipeline_spec(CFG, P=P, v=V, m=M, microbatch=MBB,
                                  seq_len=SEQ, schedule=schedule,
                                  kernels="fused")
        params = init_pipeline_params(torch.Generator().manual_seed(0), CFG,
                                      spec.layout, "cpu")
        toks = torch.from_numpy(_tokens((M, MBB, SEQ), seed=2))
        grads, met = make_train_grads_fn(spec, "cpu")(params,
                                                      {"tokens": toks})
        lp = tree_map(lambda a: a.detach().clone().requires_grad_(),
                      unstage_params(params, spec.layout))
        lm = LM(CFG, kernels="plain", device="cpu")
        ref = sum(lm.loss(lp, {"tokens": toks[i]})[0] for i in range(M))
        leaves = tree_leaves(lp)
        ref_g = torch.autograd.grad(ref, leaves)
        assert leaves[0] is lp["embed"]["tokens"] and "head" not in lp[
            "embed"]
        _PIPE[schedule] = (grads, float(met["loss"]), list(ref_g),
                           ref.item() / M, spec)
    return _PIPE[schedule]


@pytest.mark.parametrize("schedule", ["chronos", "chronos_zb"])
def test_pipeline_grads_match_lm_loss(schedule):
    """``chronos`` and ``chronos_zb`` (P=2, v=2, m=4) with the fused
    backend: the pipeline's loss and gradients against autograd through
    the port's ``LM.loss`` on the same weights."""
    grads, loss, ref, ref_loss, spec = _pipeline_vs_lm(schedule)
    ours = tree_leaves(unstage_params(grads, spec.layout))
    errs = [abs(loss - ref_loss)] + [
        float((a - b).abs().max()) for a, b in zip(ours, ref)]
    print(f"{schedule}: loss {loss:.6f}, max |pipeline - LM.loss| "
          f"{max(errs):.2e}")
    assert len(ours) == 16 and max(errs) <= PIPE_TOL


def test_tied_embedding_gradient_sums_both_ends():
    """The tied ``embed.tokens`` takes gradient from the first block's
    embedding and the last block's head; the executor's sum equals
    ``LM.loss``'s, and there is no separate head."""
    grads, _, ref, _, _ = _pipeline_vs_lm("chronos_zb")
    assert set(grads["embed"]) == {"tokens"}
    g, r = grads["embed"]["tokens"], ref[0]
    e = float((g - r).abs().max())
    print(f"embed.tokens: max |d| {e:.2e} (|ref| max "
          f"{float(r.abs().max()):.2e})")
    assert e <= 1e-6
    # both ends contribute: the head's gradient reaches every row, the
    # embedding's only the rows of tokens fed to the first block
    assert bool((r != 0).all())


def test_fp32_leaves_survive_two_adamw_steps():
    """Two steps of ``train_pipeline`` with the plain AdamW: the fp32
    ``A_log``, ``D`` and ``dt_bias`` stay fp32, move, and are written back
    from masters that do not alias them; all 16 leaves move."""
    tc = TrainConfig(model=CFG, shape=ShapeConfig("t", SEQ, M * MBB,
                                                  "train"),
                     plan=ParallelPlan(schedule="chronos_zb", num_chunks=V,
                                       microbatch_size=MBB,
                                       num_microbatches=M, kernels="plain"),
                     optimizer=OptimizerConfig(warmup_steps=1,
                                               total_steps=2, lr=1e-2),
                     seed=3)
    spec = make_pipeline_spec(CFG, P=P, v=V, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule="chronos_zb")
    params = init_pipeline_params(torch.Generator().manual_seed(3), CFG,
                                  spec.layout, "cpu")
    before = tree_map(torch.clone, params)
    out = train_pipeline(tc, P=P, device="cpu", params=params,
                         log=lambda s: None)
    assert out["params"] is params and out["steps"] == 2
    masters = out["opt_state"]["master"]
    mb = params["blocks"][0]["mamba"]
    for k in ("A_log", "D", "dt_bias"):
        w, m = mb[k], masters["blocks"][0]["mamba"][k]
        assert w.dtype == m.dtype == torch.float32, k
        assert w.data_ptr() != m.data_ptr(), k
        assert torch.equal(w, m), k
        assert not torch.equal(w, before["blocks"][0]["mamba"][k]), k
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                   tree_leaves(before))]
    assert len(moved) == 16 and all(moved)
    assert all(np.isfinite(out["losses"] + out["grad_norms"]))


def test_lm_greedy_streams_match_jax():
    """``LM.prefill_chunk`` (two 16-token chunks) then four
    ``decode_step`` s, greedy, batch 2: the port's token streams equal the
    JAX ``LM``'s and the logits agree at every step."""
    np_params = _jax_lm_params(seed=4)
    jlm, tlm = JaxLM(JCFG), LM(CFG, device="cpu")
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = lm_params_from_numpy(np_params, "cpu")
    prompt = _tokens((2, 32), seed=5)
    jc, tc = jlm.init_cache(2, 64), tlm.init_cache(2, 64)
    streams, worst = {"jax": [], "port": []}, 0.0
    for step in range(6):
        if step < 2:
            chunk = prompt[:, 16 * step:16 * (step + 1)]
            lj, jc = jlm.prefill_chunk(jp, jnp.asarray(chunk), jc,
                                       16 * step)
            with torch.no_grad():
                lt, _ = tlm.prefill_chunk(tp, torch.from_numpy(chunk), tc,
                                          16 * step)
        else:
            pos = 32 + step - 2
            lj, jc = jlm.decode_step(jp, jnp.asarray(tj), jc, pos)
            with torch.no_grad():
                lt, _ = tlm.decode_step(tp, tt, tc, pos)
        worst = max(worst, _err(lt, lj))
        tj = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
        tt = lt.argmax(-1, keepdim=True)
        streams["jax"].append(tj[:, 0].tolist())
        streams["port"].append(tt[:, 0].tolist())
    print(f"streams {streams['port']}; logits max |d| {worst:.2e}")
    assert streams["port"] == streams["jax"]
    assert worst <= LOGIT_TOL


@pytest.mark.parametrize("full", [True, False])
def test_config_matches_jax(full):
    """The port's mamba2 config equals the reference's field for field
    (the port's fields), with the same layer kinds and periods."""
    ours = get_config(ARCH) if full else CFG
    ref = jax_get_config(ARCH) if full else JCFG
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    assert [ours.layer_kind(i) for i in range(ours.num_layers)] == \
        [ref.layer_kind(i) for i in range(ref.num_layers)]
    assert ours.period == ref.period == 1
    assert pipeline_period(ours) == jax_pipeline_period(ref) == 1
    assert ours.is_attention_free and ref.is_attention_free


def test_port_init_trees_match_jax():
    """``LM.init`` and ``init_pipeline_params`` build the reference's
    trees: the same leaves, shapes and dtypes (fp32 per-head leaves
    beside weights of the parameter dtype, tied embeddings)."""
    cfg = dataclasses.replace(CFG, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    jcfg = dataclasses.replace(JCFG, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    jl, _ = JaxLM(jcfg).init(jax.random.key(0))
    tl = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    spec = make_pipeline_spec(cfg, P=P, v=V, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule="chronos")
    jpp, _ = jax_init_pipeline_params(jax.random.key(0), jcfg,
                                      JaxStageLayout.build(jcfg, P, V))
    tpp = init_pipeline_params(torch.Generator().manual_seed(0), cfg,
                               spec.layout, "cpu")
    for jt, tt in ((jl, tl), (jpp, tpp)):
        a = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jt)]
        b = [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
             for x in tree_leaves(tt)]
        assert a == b
        assert jax.tree.structure(jt) == jax.tree.structure(
            tree_map(lambda x: 0, tt))
    assert {str(x.dtype) for x in tree_leaves(tpp["blocks"])} == {
        "torch.bfloat16", "torch.float32"}


def test_serving_an_ssm_config_raises():
    """A prefill chunk off the SSD chunk grid (24 tokens against the
    reduced config's chunk of 16) is refused with a clear ValueError by
    the CLI and the engine, as the reference asserts; on the grid the
    config serves."""
    with pytest.raises(ValueError, match="chunk_len=16"):
        serve_main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--chunk", "24"])
    params = LM(CFG, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="SSD scan grid"):
        PipelinedEngine(CFG, params, P=1, chunk=24, max_seq=64,
                        device="cpu")
    PipelinedEngine(CFG, params, P=1, chunk=32, max_seq=64, device="cpu")
