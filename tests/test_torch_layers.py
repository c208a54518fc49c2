"""``repro_torch.models.layers`` against ``repro.models.layers`` on the CPU.

Both sides get the same numpy inputs made from a seed.  The JAX attention
runs with ``backend=FUSED``, so its cache prefill at a traced offset goes
through the Pallas flash kernel in interpret mode; the port's fused
backend on CPU tensors runs the kernel's plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import backend as JB
from repro.models import layers as JL
from repro_torch.models import backend as TB
from repro_torch.models import layers as TL
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

D, H, G, HD, T = 128, 8, 2, 16, 64
THETA = 10000.0


def _attn_params(rng):
    def w(shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)
    return {"wq": w((D, H * HD)), "wk": w((D, G * HD)), "wv": w((D, G * HD)),
            "wo": w((H * HD, D))}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("kernels", ["fused", "plain"])
@pytest.mark.parametrize("cache_pos,S", [(0, 16), (32, 16), (47, 1)])
def test_attention_cache_step_matches_jax(kernels, cache_pos, S):
    """Cache prefill (S=16 at offset 0 or 32) and decode (S=1 at 47): the
    output and the updated cache match JAX with the fused backend."""
    rng = np.random.default_rng(cache_pos + S)
    params = _attn_params(rng)
    x = rng.standard_normal((1, S, D)).astype(np.float32)
    cache = {"k": rng.standard_normal((1, T, G, HD)).astype(np.float32),
             "v": rng.standard_normal((1, T, G, HD)).astype(np.float32)}
    positions = (cache_pos + np.arange(S))[None].astype(np.int32)
    kw = dict(num_heads=H, num_kv=G, hd=HD, rope_theta=THETA, causal=True)

    y_j, c_j = JL.attention(_j(params), jnp.asarray(x),
                            jnp.asarray(positions), cache=_j(cache),
                            cache_pos=jnp.int32(cache_pos),
                            backend=JB.FUSED, **kw)
    tcache = _t(cache)
    y_t, c_t = TL.attention(_t(params), torch.from_numpy(x),
                            torch.from_numpy(positions).long(), cache=tcache,
                            cache_pos=cache_pos,
                            backend=TB.get_backend(kernels), **kw)
    assert c_t is tcache                       # written in place
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5,
                               rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(c_t[name].numpy(), np.asarray(c_j[name]),
                                   atol=1e-5, rtol=0)


def test_attention_no_cache_matches_jax():
    rng = np.random.default_rng(3)
    params = _attn_params(rng)
    x = rng.standard_normal((2, 24, D)).astype(np.float32)
    positions = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    kw = dict(num_heads=H, num_kv=G, hd=HD, rope_theta=THETA, causal=True)
    y_j, _ = JL.attention(_j(params), jnp.asarray(x), jnp.asarray(positions),
                          **kw)
    y_t, _ = TL.attention(_t(params), torch.from_numpy(x),
                          torch.from_numpy(positions).long(),
                          backend=TB.FUSED, **kw)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("kernels", ["fused", "plain"])
def test_attention_qkv_bias_matches_jax(kernels):
    """q/k/v biases (qwen2's ``qkv_bias``), drawn nonzero: the output
    matches JAX (1e-5) and the gradients of the biases match ``jax.grad``
    to 1e-5 of each leaf's largest entry (they reach ~900 in fp32)."""
    import jax
    rng = np.random.default_rng(5)
    params = _attn_params(rng)
    for name, width in (("bq", H * HD), ("bk", G * HD), ("bv", G * HD)):
        params[name] = rng.standard_normal(width).astype(np.float32)
    x = rng.standard_normal((2, 24, D)).astype(np.float32)
    positions = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    kw = dict(num_heads=H, num_kv=G, hd=HD, rope_theta=THETA, causal=True)

    def jloss(p):
        y, _ = JL.attention(p, jnp.asarray(x), jnp.asarray(positions), **kw)
        return jnp.sum(y * y), y
    (_, y_j), g_j = jax.value_and_grad(jloss, has_aux=True)(_j(params))
    tp = {k: v.requires_grad_() for k, v in _t(params).items()}
    y_t, _ = TL.attention(tp, torch.from_numpy(x),
                          torch.from_numpy(positions).long(),
                          backend=TB.get_backend(kernels), **kw)
    g_t = torch.autograd.grad((y_t * y_t).sum(), [tp[n] for n in
                                                  ("bq", "bk", "bv")])
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               atol=1e-5, rtol=0)
    for n, g in zip(("bq", "bk", "bv"), g_t):
        ref = np.asarray(g_j[n])
        assert np.abs(g.numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), n


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, HD)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 8)).astype(np.int32)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                        THETA)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), THETA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    rng = np.random.default_rng(1)
    p = {"wi": rng.standard_normal((D, 96)).astype(np.float32) / 11,
         "wo": rng.standard_normal((96, D)).astype(np.float32) / 10}
    if act == "silu":
        p["wg"] = rng.standard_normal((D, 96)).astype(np.float32) / 11
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    got = TL.mlp(_t(p), torch.from_numpy(x), act)
    want = JL.mlp(_j(p), jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("tied", [False, True])
def test_embed_unembed_match_jax(tied):
    rng = np.random.default_rng(2)
    p = {"tokens": rng.standard_normal((50, D)).astype(np.float32)}
    if not tied:
        p["head"] = rng.standard_normal((D, 50)).astype(np.float32) / 11
    toks = rng.integers(0, 50, size=(2, 7))
    e_t = TL.embed(_t(p), torch.from_numpy(toks))
    e_j = JL.embed(_j(p), jnp.asarray(toks))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=0, rtol=0)
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    u_t = TL.unembed(_t(p), torch.from_numpy(x))
    u_j = JL.unembed(_j(p), jnp.asarray(x))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-5,
                               rtol=1e-6)


@pytest.mark.parametrize("window,prefix", [(0, 0), (5, 0), (0, 3), (4, 2)])
@pytest.mark.parametrize("window_as_data", [False, True])
def test_make_mask_matches_jax(window, prefix, window_as_data):
    q_pos = np.arange(10, 22)[None].astype(np.int32)
    kv_pos = np.arange(24).astype(np.int32)
    w_t = torch.tensor(window) if window_as_data else window
    w_j = jnp.int32(window) if window_as_data else window
    got = TL.make_mask(torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                       causal=True, window=w_t, prefix_len=prefix)
    want = JL.make_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=True,
                        window=w_j, prefix_len=prefix)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rmsnorm_layer_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, D)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# qwen2-72b (reduced: 4 layers, d 128, GQA 8/2, q/k/v biases), fp32
# ---------------------------------------------------------------------------

def _qwen2_models():
    """The reduced qwen2 in both packages, the JAX ``LM.init`` weights
    with the q/k/v biases redrawn nonzero, as numpy."""
    import jax
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import LM as JaxLM
    from repro_torch.configs import get_reduced
    jcfg, cfg = jax_get_reduced("qwen2-72b"), get_reduced("qwen2-72b")
    params, _ = JaxLM(jcfg).init(jax.random.key(0))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(9)
    for layer in params["layers"]:
        for n in ("bq", "bk", "bv"):
            a = layer["attn"][n]
            layer["attn"][n] = (0.5 * rng.standard_normal(a.shape)).astype(
                a.dtype)
    return jcfg, cfg, params


def test_qwen2_reduced_loss_and_grads_match_jax():
    """``LM.loss`` and every gradient leaf of the reduced qwen2 against
    JAX ``jax.grad`` (1e-5, as the other archs' pairs)."""
    import jax
    from repro.models import LM as JaxLM
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.models import LM
    from repro_torch.tree import tree_leaves, tree_map
    jcfg, cfg, np_params = _qwen2_models()
    assert cfg.qkv_bias and "bq" in np_params["layers"][0]["attn"]
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)
    lm_j = JaxLM(jcfg)
    ref_loss, ref_g = jax.jit(jax.value_and_grad(
        lambda p: lm_j.loss(p, {"tokens": jnp.asarray(tokens)})[0]))(
        jax.tree.map(jnp.asarray, np_params))
    p = tree_map(lambda a: a.requires_grad_(),
                 lm_params_from_numpy(np_params, "cpu"))
    loss = LM(cfg, kernels="fused", device="cpu").loss(
        p, {"tokens": torch.from_numpy(tokens)})[0]
    grads = torch.autograd.grad(loss, tree_leaves(p))
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5
    ref_leaves = jax.tree.leaves(ref_g)
    assert len(grads) == len(ref_leaves)
    for g, r in zip(grads, ref_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0)


def test_qwen2_reduced_serves_as_jax():
    """The pipelined engine (P=2) serves the reduced qwen2: its greedy
    streams equal the JAX single-host ``prefill_chunk`` /
    ``decode_step`` streams."""
    import jax
    from repro.models import LM as JaxLM
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.serve import PipelinedEngine, Request
    jcfg, cfg, np_params = _qwen2_models()
    chunk, max_seq = 16, 64
    rng = np.random.default_rng(4)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, chunk * (i + 1)).tolist(), max_new=4)
        for i in range(2)]
    lm_j = JaxLM(jcfg)
    pj = jax.tree.map(jnp.asarray, np_params)
    want = {}
    for req in reqs:
        cache = lm_j.init_cache(1, max_seq)
        toks = np.asarray(req.prompt)[None]
        for q in range(len(req.prompt) // chunk):
            logits, cache = lm_j.prefill_chunk(
                pj, toks[:, q * chunk:(q + 1) * chunk], cache, q * chunk)
        pos = len(req.prompt)
        stream = [int(np.argmax(np.asarray(logits)[0]))]
        while len(stream) < req.max_new:
            logits, cache = lm_j.decode_step(pj, np.asarray([[stream[-1]]]),
                                             cache, pos)
            pos += 1
            stream.append(int(np.argmax(np.asarray(logits)[0])))
        want[req.rid] = stream
    eng = PipelinedEngine(cfg, lm_params_from_numpy(np_params, "cpu"), P=2,
                          chunk=chunk, max_seq=max_seq, n_slots=2,
                          device="cpu")
    res = eng.serve(reqs, clock=None)
    assert res["nonfinite_logits"] == 0
    for r in reqs:
        assert res["finished"][r.rid].tokens == want[r.rid], r.rid
