"""Chronos-Recomp of the port (``LM.loss(recomp=, num_chunks=)``) against
the JAX package, on the reduced tinyllama (4 layers, d 128) and mamba2 (4
layers, d 128, state 16, chunk 16), fp32, on the CPU.

- ``LM.loss(recomp=, num_chunks=)`` against JAX ``LM.loss`` with the same
  arguments under ``jax.grad``, for every recompute mode and policy;
- the port's remat against no remat, bitwise;
- the selective policy saves exactly the 2-D projection outputs, as many
  as the JAX layer body has batch-free ``dot_general`` s;
- a masked loss, and ``blockwise_attention`` against the reference's.

``train()`` itself is held against the JAX ``train()`` in
``test_torch_train_single.py``.  Weights come from the JAX ``LM.init``
and cross as numpy; tokens, masks and attention inputs are made with
numpy from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import get_reduced as jax_get_reduced
from repro.models import LM as JaxLM
from repro.models import layers as JL
from repro.models.transformer import _apply_layer as jax_apply_layer
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import base as TB
from repro_torch.configs import get_reduced
from repro_torch.models import LM
from repro_torch.models import backend as TBK
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("tinyllama-1.1b", "mamba2-2.7b")
# projections per layer: q, k, v, o, wi, wg, mlp-wo; z, x, B, C, dt, out
PROJECTIONS = {"tinyllama-1.1b": 7, "mamba2-2.7b": 6}
SEQ = 33                  # 32 positions: two SSD chunks of 16
LOSS_TOL = 1e-5           # loss, port vs JAX (atol)
GRAD_TOL = 1e-5           # every gradient leaf (test_torch_train_mamba.py)
ATTN_TOL = 1e-5           # attention outputs (test_torch_layers.py)
MODES = {"none": dict(mode="none"),
         "chronos-full": dict(mode="chronos", policy="full"),
         "chronos-selective": dict(mode="chronos", policy="selective"),
         "uniform": dict(mode="uniform"),
         "full": dict(mode="full")}


def _redraw(tree, seed):
    """The per-head leaves and norm scales of a numpy LM tree redrawn from
    ``seed``, so that no gradient is trivially zero (in place)."""
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


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_reduced(arch), **kw),
            dataclasses.replace(jax_get_reduced(arch), **kw))


def _np_params(jcfg, seed=0):
    params, _ = JaxLM(jcfg).init(jax.random.key(seed))
    return _redraw(jax.tree.map(np.asarray, params), seed + 10)


def _batch(cfg, seed=1, masked=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)}
    if masked:                          # a ragged tail of each row masked
        keep = rng.integers(SEQ // 2, SEQ, (2, 1))
        b["loss_mask"] = (np.arange(SEQ)[None] < keep).astype(np.float32)
    return b


def _jax_loss_grads(jcfg, np_params, batch, recomp=None, num_chunks=1):
    lm = JaxLM(jcfg)
    loss, g = jax.jit(jax.value_and_grad(lambda p, b: lm.loss(
        p, b, recomp=recomp, num_chunks=num_chunks)[0]))(
        jax.tree.map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.leaves(g)


def _port_loss_grads(cfg, params, batch, recomp=None, num_chunks=1,
                     kernels="fused"):
    p = tree_map(lambda a: a.detach().clone().requires_grad_(), params)
    loss = LM(cfg, kernels=kernels, device="cpu").loss(
        p, {k: torch.from_numpy(v) for k, v in batch.items()},
        recomp=recomp, num_chunks=num_chunks)[0]
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(p))


def _assert_pair(loss, grads, ref_loss, ref_grads):
    assert len(grads) == len(ref_grads)
    e_l = abs(float(loss) - ref_loss)
    e_g = max(float(np.abs(a.numpy() - np.asarray(b)).max())
              for a, b in zip(grads, ref_grads))
    print(f"loss {float(loss):.6f} vs {ref_loss:.6f} (|d| {e_l:.2e}), "
          f"grads max |d| {e_g:.2e}")
    assert e_l <= LOSS_TOL and e_g <= GRAD_TOL


# ---------------------------------------------------------------------------
# RecomputeConfig and LM.loss(recomp=, num_chunks=)
# ---------------------------------------------------------------------------

def test_recompute_config_is_the_reference():
    fields = [(f.name, f.default)
              for f in dataclasses.fields(TB.RecomputeConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(JB.RecomputeConfig)]


@pytest.mark.parametrize("num_chunks", [1, 2, 3])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_recomp_matches_jax(arch, mode, num_chunks):
    """num_chunks=3 splits the 4 periods 1 + 2 + 1 (an uneven chunk)."""
    cfg, jcfg = _cfgs(arch)
    np_params = _np_params(jcfg)
    batch = _batch(cfg)
    ref = _jax_loss_grads(jcfg, np_params, batch,
                          JB.RecomputeConfig(**MODES[mode]), num_chunks)
    got = _port_loss_grads(cfg, lm_params_from_numpy(np_params, "cpu"),
                           batch, TB.RecomputeConfig(**MODES[mode]),
                           num_chunks)
    _assert_pair(*got, *ref)


@pytest.mark.parametrize("num_chunks", [1, 2, 3])
@pytest.mark.parametrize("mode", ["chronos-full", "full"])
def test_remainder_layer_runs_unwrapped_as_jax(mode, num_chunks):
    """Period 2 (local/global windows), 5 layers: two periods, one
    remainder layer; num_chunks=3 leaves an empty chunk."""
    cfg, jcfg = _cfgs("tinyllama-1.1b", num_layers=5, sliding_window=8,
                      attn_pattern_period=2, global_offsets=(1,))
    lm = LM(cfg, device="cpu")
    assert (lm.period, lm.num_periods, lm.num_rem) == (2, 2, 1)
    np_params = _np_params(jcfg)
    batch = _batch(cfg)
    rc = TB.RecomputeConfig(**MODES[mode])
    ref = _jax_loss_grads(jcfg, np_params, batch,
                          JB.RecomputeConfig(**MODES[mode]), num_chunks)
    params = lm_params_from_numpy(np_params, "cpu")
    got = _port_loss_grads(cfg, params, batch, rc, num_chunks)
    _assert_pair(*got, *ref)
    plain = _port_loss_grads(cfg, params, batch)
    assert torch.equal(got[0], plain[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], plain[1]))


@pytest.mark.parametrize("kernels", ["fused", "plain"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_bitwise(arch, mode, kernels):
    cfg, jcfg = _cfgs(arch)
    params = lm_params_from_numpy(_np_params(jcfg), "cpu")
    batch = _batch(cfg, seed=2)
    l0, g0 = _port_loss_grads(cfg, params, batch, kernels=kernels)
    for nc in (2, 3):
        l1, g1 = _port_loss_grads(cfg, params, batch,
                                  TB.RecomputeConfig(**MODES[mode]), nc,
                                  kernels=kernels)
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _batch_free_dots(jaxpr) -> int:
    """``dot_general`` s without batch dimensions in ``jaxpr`` and its
    sub-jaxprs: what ``dots_with_no_batch_dims_saveable`` saves."""
    n = 0
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            _, (lb, rb) = e.params["dimension_numbers"]
            n += not lb and not rb
        for v in e.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    n += _batch_free_dots(sub)
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_selective_policy_saves_the_projections(arch, monkeypatch):
    """A recording wrapper around the policy counts the outputs it saves
    in the forward: 7 (tinyllama) or 6 (mamba2) per layer of a selective
    chunk, none in a fully rematerialized one."""
    cfg, jcfg = _cfgs(arch)
    np_params = _np_params(jcfg)
    lp = jax.tree.map(lambda a: jnp.asarray(a[0]), np_params["layers"][0])
    x = jnp.ones((2, SEQ - 1, cfg.d_model), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(SEQ - 1)[None], (2, SEQ - 1))
    jaxpr = jax.make_jaxpr(lambda p, h: jax_apply_layer(
        p, h, pos, jcfg, 0, aux_sum=jnp.zeros(()))[0])(lp, x)
    assert _batch_free_dots(jaxpr.jaxpr) == PROJECTIONS[arch]

    saved = []
    policy = TT.dots_with_no_batch_dims_saveable

    def recording(ctx, func, *args, **kwargs):
        out = policy(ctx, func, *args, **kwargs)
        if not ctx.is_recompute and out == TT.CheckpointPolicy.MUST_SAVE:
            saved.append(func)
        return out

    monkeypatch.setattr(TT, "dots_with_no_batch_dims_saveable", recording)
    params = lm_params_from_numpy(np_params, "cpu")
    L = cfg.num_layers
    for rc, nc, selective_layers in (
            (TB.RecomputeConfig("none"), 2, L),
            (TB.RecomputeConfig("uniform"), 3, L),
            (TB.RecomputeConfig("chronos", policy="full"), 2, L // 2),
            (TB.RecomputeConfig("chronos", policy="full"), 3, L - 1),
            (TB.RecomputeConfig("chronos", policy="selective"), 2, L),
            (TB.RecomputeConfig("full"), 2, 0)):
        saved.clear()
        _port_loss_grads(cfg, params, _batch(cfg), rc, nc)
        assert len(saved) == PROJECTIONS[arch] * selective_layers, (rc, nc)
        assert set(saved) <= TT.SAVED_OPS


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_loss_matches_jax(arch):
    cfg, jcfg = _cfgs(arch)
    np_params = _np_params(jcfg)
    batch = _batch(cfg, seed=3, masked=True)
    assert 0 < batch["loss_mask"][:, 1:].mean() < 1
    ref = _jax_loss_grads(jcfg, np_params, batch)
    got = _port_loss_grads(cfg, lm_params_from_numpy(np_params, "cpu"),
                           batch, TB.RecomputeConfig("chronos"), 2)
    _assert_pair(*got, *ref)
    unmasked = _port_loss_grads(cfg, lm_params_from_numpy(np_params, "cpu"),
                                {"tokens": batch["tokens"]})
    assert abs(float(got[0]) - float(unmasked[0])) > 1e-4


# ---------------------------------------------------------------------------
# blockwise attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,prefix,q_offset", [
    (True, 0, 0, 0), (True, 6, 0, 0), (True, 0, 5, 0), (False, 0, 0, 0),
    (True, 0, 0, 7), (True, 6, 3, 7)])
def test_blockwise_attention_matches_jax(causal, window, prefix, q_offset):
    """kv of 27 positions in blocks of 8 (the last one padded)."""
    B, H, G, hd, T = 2, 4, 2, 16, 27
    S = T - q_offset
    rng = np.random.default_rng(q_offset + 10 * window + prefix)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, G, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, G, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, prefix_len=prefix,
              q_offset=q_offset, block=8)
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), 0.25, **kw)
    got = TL.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), 0.25, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_TOL, rtol=0)


def test_attention_past_the_dense_threshold_is_blockwise(monkeypatch):
    """The plain backend takes ``blockwise_attention`` for a kv longer
    than ``dense_threshold``, as the reference does, and agrees with it;
    the fused backend keeps the flash path."""
    D, H, G, hd, S = 64, 4, 2, 16, 24
    rng = np.random.default_rng(7)
    params = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
              for n, s in (("wq", (D, H * hd)), ("wk", (D, G * hd)),
                           ("wv", (D, G * hd)), ("wo", (H * hd, D)))}
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    kw = dict(num_heads=H, num_kv=G, hd=hd, rope_theta=10000.0, causal=True,
              dense_threshold=16)
    want, _ = JL.attention({k: jnp.asarray(a) for k, a in params.items()},
                           jnp.asarray(x), jnp.asarray(pos), **kw)
    calls = []
    blockwise = TL.blockwise_attention
    monkeypatch.setattr(TL, "blockwise_attention",
                        lambda *a, **k: calls.append(1) or blockwise(*a, **k))
    tp = {k: torch.from_numpy(a) for k, a in params.items()}
    got, _ = TL.attention(tp, torch.from_numpy(x),
                          torch.from_numpy(pos).long(), backend=TBK.PLAIN,
                          **kw)
    assert calls == [1]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATTN_TOL, rtol=0)
    TL.attention(tp, torch.from_numpy(x), torch.from_numpy(pos).long(),
                 backend=TBK.FUSED, **kw)
    assert calls == [1]
