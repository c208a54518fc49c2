"""Shared pairs of the port's CPU tests for the windowed, VLM and
encoder-decoder configs: the same seeded numpy inputs through the JAX
package and the port, held against single-host JAX oracles (``LM.loss``
under ``jax.grad``, and the ``prefill``/``decode_step`` streams).

Weights come from the JAX package's inits and cross as numpy; everything
runs in fp32, where the two sides differ only in the order of their
sums."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analysis as JA
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.models import LM as JaxLM
from repro.plan import plan_under_budget as jax_plan
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.core import analysis as TA
from repro_torch.core.pipeline_runtime import (make_pipeline_spec,
                                               make_train_grads_fn,
                                               unstage_params)
from repro_torch.models import LM
from repro_torch.plan import plan_under_budget
from repro_torch.tree import tree_leaves, tree_map

LOSS_TOL = 1e-5           # LM.loss, port vs JAX (atol)
GRAD_TOL = 1e-5           # LM.loss gradients, relative per leaf
PIPE_TOL = 2e-5           # pipeline loss and gradients vs jax.grad
LOGIT_TOL = 1e-4          # fp32 stream logits


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def batch_np(cfg, lead, seq, seed):
    """Seeded numpy inputs of shape ``lead`` + (...): ``tokens`` [..,
    seq], and the config's ``patch_embeds`` [.., P, d] or
    ``frame_embeds`` [.., T, d] (N(0, 1) fp32)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, lead + (seq,))
           .astype(np.int32)}
    if cfg.vision is not None:
        out["patch_embeds"] = rng.standard_normal(
            lead + (cfg.vision.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.encdec is not None:
        out["frame_embeds"] = rng.standard_normal(
            lead + (cfg.encdec.num_frames, cfg.d_model)).astype(np.float32)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(a) for k, a in batch.items()}


_VG = {}


def jax_value_and_grad(jcfg):
    """jit of ``value_and_grad`` of JAX ``LM.loss`` on one batch (one
    compile per config)."""
    if jcfg not in _VG:
        lm = JaxLM(jcfg)
        _VG[jcfg] = jax.jit(jax.value_and_grad(
            lambda p, b: lm.loss(p, b), has_aux=True))
    return _VG[jcfg]


def loss_pair(cfg, jcfg, seq=41, seed=1):
    """Port ``LM.loss`` (fused backend) and every gradient against JAX's on
    bridged weights.  Returns (loss |d|, worst gradient relative error,
    number of leaves)."""
    params, _ = JaxLM(jcfg).init(jax.random.key(0))
    b = batch_np(cfg, (2,), seq, seed)
    (loss_j, _), grads_j = jax_value_and_grad(jcfg)(params, b)
    tp = tree_map(lambda a: a.requires_grad_(), lm_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    loss, _ = LM(cfg, kernels="fused", device="cpu").loss(tp, to_torch(b))
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    ref = jax.tree.leaves(grads_j)
    assert len(grads) == len(ref)
    return (abs(float(loss.detach()) - float(loss_j)),
            max(rel(a, c) for a, c in zip(grads, ref)), len(ref))


def pipeline_pair(cfg, jcfg, schedule, v, P=2, m=4, mbB=2, seq=17):
    """The executor on ``P`` virtual stages against ``jax.grad`` of the
    mean over the microbatches of JAX ``LM.loss``, on the same weights
    (the JAX package's ``init_pipeline_params``, unstaged).  Returns
    (loss |d|, worst gradient relative error, the port's unstaged
    gradients, the reference's gradient leaves)."""
    jp, _ = jax_init_pipeline_params(jax.random.key(0), jcfg,
                                     JaxStageLayout.build(jcfg, P, v))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    spec = make_pipeline_spec(cfg, P=P, v=v, m=m, microbatch=mbB,
                              seq_len=seq, schedule=schedule,
                              kernels="fused")
    b = batch_np(cfg, (m, mbB), seq, 2)
    grads, met = make_train_grads_fn(spec, "cpu")(params, to_torch(b))
    lm_p = jax.tree.map(jnp.asarray, tree_map(
        lambda a: a.numpy(), unstage_params(params, spec.layout)))
    vg = jax_value_and_grad(jcfg)
    ref_loss, ref_g = 0.0, None
    for i in range(m):
        (loss_i, _), g = vg(lm_p, {k: a[i] for k, a in b.items()})
        ref_loss += float(loss_i) / m
        g = [np.asarray(a) for a in jax.tree.leaves(g)]
        ref_g = g if ref_g is None else [a + c for a, c in zip(ref_g, g)]
    ours = unstage_params(grads, spec.layout)
    leaves = tree_leaves(ours)
    assert len(leaves) == len(ref_g)
    return (abs(float(met["loss"]) - ref_loss),
            max(rel(a, c) for a, c in zip(leaves, ref_g)), ours, ref_g)


def stream_pair(cfg, jcfg, prompt_len, n_new, max_seq, seed=3,
                between=None):
    """Greedy single-host streams: ``prefill`` of one prompt (with the
    config's patch or frame embeddings) and ``n_new - 1`` decode steps,
    port (fused backend) against JAX on bridged weights.  ``between(lm,
    cache)`` runs after the port's prefill.  Returns (port tokens, JAX
    tokens, worst logit |d|)."""
    lm_j = JaxLM(jcfg)
    params_j, _ = lm_j.init(jax.random.key(0))
    b = batch_np(cfg, (1,), prompt_len, seed)
    kw = {k: a for k, a in b.items() if k != "tokens"}
    lm = LM(cfg, kernels="fused", device="cpu")
    params = lm_params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    streams, logits = [], []
    for side in ("jax", "port"):
        if side == "jax":
            cache = lm_j.init_cache(1, max_seq)
            lg, cache = jax.jit(lm_j.prefill)(params_j, b["tokens"], cache,
                                              **kw)
            step = jax.jit(lm_j.decode_step)
        else:
            cache = lm.init_cache(1, max_seq)
            lg, cache = lm.prefill(params, torch.from_numpy(b["tokens"]),
                                   cache, **{k: torch.from_numpy(a)
                                             for k, a in kw.items()})
            if between is not None:
                between(lm, cache)

            def step(p, t, c, pos):
                return lm.decode_step(p, torch.from_numpy(np.asarray(t)), c,
                                      pos)
        pos = prompt_len + (cfg.vision.num_patches if cfg.vision else 0)
        toks, lgs = [], []
        while True:
            lgs.append(np.asarray(lg, dtype=np.float32)[0])
            toks.append(int(np.argmax(lgs[-1])))
            if len(toks) == n_new:
                break
            lg, cache = step(params_j if side == "jax" else params,
                             np.asarray([[toks[-1]]], np.int32), cache, pos)
            pos += 1
        streams.append(toks)
        logits.append(lgs)
    worst = max(float(np.abs(a - c).max())
                for a, c in zip(logits[0], logits[1]))
    return streams[1], streams[0], worst


def planner_pair(cfg, jcfg):
    """``MemoryModel`` (every field, ``m_a``, ``model_state``),
    ``max_trainable_layers`` over a grid of budgets, and
    ``plan_under_budget`` under the one-card query (a quarter of an 80 GB
    card per stage; the same pick, or the same refusal) equal to the
    reference's."""
    for tp in (1, 8):
        ours, ref = TA.MemoryModel.build(cfg, tp=tp), \
            JA.MemoryModel.build(jcfg, tp=tp)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.m_a(2049, 18) == ref.m_a(2049, 18)
        assert ours.model_state(18, 4, tp) == ref.model_state(18, 4, tp)
    for hbm_gb, pp, frac, off in itertools.product(
            (16, 21.25, 80), (4, 8), (0.5, 1.0), (0.0, 0.5)):
        kw = dict(hbm_bytes=hbm_gb * 1e9, pp=pp, tp=1,
                  microbatch_tokens=2049, act_frac_of_ma=frac,
                  offload_frac=off)
        assert TA.max_trainable_layers(cfg, **kw) == \
            JA.max_trainable_layers(jcfg, **kw), kw
    kw = dict(pp=4, tp=1, hbm_bytes=85e9 / 4, microbatch=1, seq_len=2049)
    try:
        want = jax_plan(jcfg, **kw).summary()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            plan_under_budget(cfg, **kw)
        assert str(got.value) == str(e)
        return None
    got = plan_under_budget(cfg, **kw).summary()
    assert got == want
    return got
