"""The port's kernel wrappers (on CPU tensors: their plain versions) against
the JAX package's Pallas kernels in interpret mode and its ``ref.py``
oracles.  Inputs are made with numpy from a seed and handed to both.
The autograd Functions around the kernels (kernel forward, plain-version
backward) are checked against autograd through the plain versions.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``; here no kernel is built or launched, and the
launch counters must stay at zero."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import \
    flash_attention_fwd as jax_flash_fwd
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.kernels.rmsnorm.ops import rmsnorm_fused as jax_rmsnorm_fused
from repro.kernels.rmsnorm.ref import rmsnorm_rows_ref as jax_rmsnorm_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention_fwd)
from repro_torch.kernels.rmsnorm import (rmsnorm_fused, rmsnorm_rows,
                                         rmsnorm_rows_ref)
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

RMS_TOL = 1e-6
FLASH_TOL = 1e-5


@pytest.mark.parametrize("R", [1, 37, 300])   # 300: not a 256-row multiple
def test_rmsnorm_rows_matches_pallas(R):
    rng = np.random.default_rng(R)
    x = rng.standard_normal((R, 128)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    before = rmsnorm_rows.launches
    got = rmsnorm_rows(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    assert rmsnorm_rows.launches == before      # plain version, no kernel
    want = np.asarray(jax_rmsnorm_fused(jnp.asarray(x), jnp.asarray(scale),
                                        1e-6))
    np.testing.assert_allclose(got.numpy(), want, atol=RMS_TOL, rtol=0)
    ref = np.asarray(jax_rmsnorm_ref(jnp.asarray(x), jnp.asarray(scale),
                                     1e-6))
    np.testing.assert_allclose(rmsnorm_rows_ref(
        torch.from_numpy(x), torch.from_numpy(scale)).numpy(), ref,
        atol=RMS_TOL, rtol=0)


def test_rmsnorm_fused_any_leading_shape():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 5, 128)).astype(np.float32))
    scale = torch.ones(128)
    got = rmsnorm_fused(x, scale)
    assert got.shape == x.shape
    np.testing.assert_allclose(
        got.numpy(), rmsnorm_rows_ref(x.reshape(10, 128), scale)
        .reshape(2, 5, 128).numpy(), atol=0, rtol=0)


# (q_offset, window, prefix): GQA H=8 over G=2, hd=16, Sq=16, Sk=96 (not a
# multiple of the TPU kernel's 128-wide blocks)
FLASH_CASES = [(0, 0, 0), (32, 0, 0), (80, 0, 0), (32, 8, 0), (32, 0, 4)]


def _flash_inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 16, 8, 16)).astype(np.float32)
    k = rng.standard_normal((1, 96, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 96, 2, 16)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("q_offset,window,prefix", FLASH_CASES)
def test_flash_matches_pallas_dynamic_offset(q_offset, window, prefix):
    q, k, v = _flash_inputs(q_offset + window + prefix)
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, prefix=prefix, q_offset=q_offset)
    assert flash_attention_fwd.launches == before
    o_j, lse_j = jax_flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, prefix=prefix, q_offset=jnp.int32(q_offset),
        interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=FLASH_TOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                               atol=FLASH_TOL, rtol=0)


@pytest.mark.parametrize("q_offset,window,prefix", FLASH_CASES)
def test_attention_ref_matches_jax_ref(q_offset, window, prefix):
    q, k, v = _flash_inputs(100 + q_offset + window + prefix)
    o, lse = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True, window=window,
                           prefix=prefix, q_offset=q_offset)
    o_j, lse_j = jax_attn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window, prefix=prefix,
                              q_offset=q_offset)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=FLASH_TOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                               atol=FLASH_TOL, rtol=0)


def test_attention_ref_fully_masked_row_averages_v():
    """A row that sees no key (its position is past the buffer) averages
    v with equal weights, as the reference's finite NEG_INF makes it."""
    q, k, v = _flash_inputs(7)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    o, lse = attention_ref(qt, kt[:, :8], vt[:, :8], causal=True,
                           window=2, q_offset=20)
    o_j, lse_j = jax_attn_ref(jnp.asarray(q), jnp.asarray(k[:, :8]),
                              jnp.asarray(v[:, :8]), causal=True, window=2,
                              q_offset=20)
    mean_v = vt[:, :8].mean(dim=1).repeat_interleave(4, dim=1)   # [1,H,d]
    np.testing.assert_allclose(o[:, 0].numpy(), mean_v.numpy(), atol=1e-6)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-6)


# Widths the vector path of the RMSNorm kernel takes (mamba2's 2560 and
# 5120) and one it cannot (100: not a multiple of 8 bf16 values), in both
# types.  fp32 at FLASH_TOL (sum order only); bf16 within one rounding step
# of the output, 2^-7 relative.
@pytest.mark.parametrize("d", [2560, 5120, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rows_matches_pallas_at_model_widths(d, dtype):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((5, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    xt, st = (torch.from_numpy(a).to(getattr(torch, dtype))
              for a in (x, scale))
    got = rmsnorm_rows(xt, st, 1e-6).float().numpy()
    want = np.asarray(jax_rmsnorm_fused(
        jnp.asarray(x, dtype=dtype), jnp.asarray(scale, dtype=dtype), 1e-6)
        .astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=FLASH_TOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=RMS_TOL, rtol=2.0 ** -7)
    assert rmsnorm_rows.launches == 0


# The cases the tensor-core tiles of the CUDA kernel can get wrong, held
# against the Pallas kernel with a static int q_offset (``_fwd_kernel``):
# head dims 64 and 128, Sq and Sk off every tile size (16, 64, 128), H == G,
# window and prefix edges, and bf16 inputs.  (d, Sq, Sk, H, G, q_offset,
# window, prefix, dtype)
FLASH_TILE_CASES = [
    (64, 37, 150, 4, 4, 113, 0, 0, "float32"),
    (128, 53, 201, 4, 2, 148, 0, 0, "float32"),
    (64, 100, 100, 2, 1, 0, 0, 0, "bfloat16"),
    (128, 45, 133, 2, 2, 88, 16, 5, "bfloat16"),
    (64, 70, 190, 4, 2, 120, 24, 0, "bfloat16"),
]


@pytest.mark.parametrize("d,Sq,Sk,H,G,q_offset,window,prefix,dtype",
                         FLASH_TILE_CASES)
def test_flash_matches_pallas_static_offset(d, Sq, Sk, H, G, q_offset,
                                            window, prefix, dtype):
    """bf16: both compute in fp32 from the same bf16 inputs and round o
    once, so o agrees within one bf16 step (2^-7 relative) and lse within
    FLASH_TOL."""
    rng = np.random.default_rng(d + Sq + Sk)
    q = rng.standard_normal((1, Sq, H, d)).astype(np.float32)
    k = rng.standard_normal((1, Sk, G, d)).astype(np.float32)
    v = rng.standard_normal((1, Sk, G, d)).astype(np.float32)
    o, lse = flash_attention_fwd(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        causal=True, window=window, prefix=prefix, q_offset=q_offset)
    o_j, lse_j = jax_flash_fwd(
        *(jnp.asarray(a, dtype=dtype) for a in (q, k, v)), causal=True,
        window=window, prefix=prefix, q_offset=q_offset, interpret=True)
    o_j = np.asarray(o_j.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(o.numpy(), o_j, atol=FLASH_TOL, rtol=0)
    else:
        np.testing.assert_allclose(o.float().numpy(), o_j, atol=RMS_TOL,
                                   rtol=2.0 ** -7)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                               atol=FLASH_TOL, rtol=0)
    assert flash_attention_fwd.launches == 0


# ---------------------------------------------------------------------------
# the autograd Functions around the kernels (kernel forward, plain backward)
# ---------------------------------------------------------------------------

class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: stands in for a CUDA
    request on a machine that has no card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _graph_names(t):
    """Names of the autograd nodes reachable from ``t.grad_fn``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


def _layer_inputs(seed):
    from repro_torch.configs import get_reduced
    from repro_torch.models import LM
    cfg = get_reduced("tinyllama-1.1b")
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    layer = {k: {n: a[0] for n, a in v.items()}
             for k, v in params["layers"][0].items()}
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model))
                         .astype(np.float32))
    return cfg, layer, x


def test_fused_backend_outputs_carry_the_functions_grad_fn():
    from repro_torch.models.backend import FUSED
    x = torch.randn(2, 5, 128, requires_grad=True)
    y = FUSED.rmsnorm({"scale": torch.ones(128)}, x)
    assert "RMSNormRowsBackward" in _graph_names(y)
    q = torch.randn(1, 16, 8, 16, requires_grad=True)
    kv = torch.randn(1, 16, 2, 16, requires_grad=True)
    o = FUSED.flash(q, kv, kv, causal=True, window=0, prefix=0)
    assert "FlashAttentionBackward" in _graph_names(o)


def test_fused_layer_gradients_equal_the_plain_layer_on_cpu():
    """One decoder layer through the fused backend (the Functions) and
    the plain one (dense attention): same forward within FLASH_TOL, same
    gradients for the input and every weight within 1e-5."""
    from repro_torch.models.backend import FUSED, PLAIN
    from repro_torch.models.transformer import _apply_layer
    cfg, layer, x = _layer_inputs(0)
    pos = torch.arange(24)[None].expand(2, 24)
    outs, grads = [], []
    for bk in (FUSED, PLAIN):
        p = {k: {n: a.clone().requires_grad_() for n, a in v.items()}
             for k, v in layer.items()}
        xi = x.clone().requires_grad_()
        y, _, aux = _apply_layer(p, xi, pos, cfg, 0, backend=bk)
        assert aux == 0.0           # no MoE layer: the aux sum is untouched
        wrt = [xi] + [a for v in p.values() for a in v.values()]
        grads.append(torch.autograd.grad(y.square().sum(), wrt))
        outs.append(y.detach())
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                               atol=FLASH_TOL, rtol=0)
    worst = max(float((a - b).abs().max() / (1 + b.abs().max()))
                for a, b in zip(*grads))
    print(f"fused vs plain layer gradients: max rel |d| = {worst:.3e}")
    assert worst <= 1e-5


def test_rmsnorm_function_gradients_are_the_plain_versions():
    """The Function's backward is autograd through ``rmsnorm_rows_ref``:
    on the CPU (where the forward is the plain version too) the two are
    bitwise equal."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 7, 128)).astype(np.float32))
    s = torch.from_numpy((1 + 0.1 * rng.standard_normal(128))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((3, 7, 128)).astype(np.float32))
    a = [x.clone().requires_grad_(), s.clone().requires_grad_()]
    b = [x.clone().requires_grad_(), s.clone().requires_grad_()]
    rmsnorm_fused(*a).backward(dy)
    rmsnorm_rows_ref(b[0].reshape(-1, 128), b[1]).reshape(3, 7, 128) \
        .backward(dy)
    for u, w in zip(a, b):
        assert torch.equal(u.grad, w.grad)


def test_functions_on_cuda_tensors_launch_or_raise(monkeypatch):
    """A tensor that reports a CUDA device goes through the Function to
    the kernel wrapper, and from there to the build (stubbed to fail):
    never to the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention

    class Refused(Exception):
        pass

    def refuse():
        raise Refused

    monkeypatch.setattr(build, "load_library", refuse)
    before = (rmsnorm_rows.launches, flash_attention_fwd.launches)
    x = torch.zeros((2, 4, 128)).as_subclass(_CudaLooking) \
        .requires_grad_()
    s = torch.ones(128).as_subclass(_CudaLooking)
    with pytest.raises(Refused):
        rmsnorm_fused(x, s)
    q = torch.zeros((1, 16, 8, 16)).as_subclass(_CudaLooking) \
        .requires_grad_()
    kv = torch.zeros((1, 16, 2, 16)).as_subclass(_CudaLooking)
    with pytest.raises(Refused):
        flash_attention(q, kv, kv)
    assert (rmsnorm_rows.launches, flash_attention_fwd.launches) == before


def test_fused_adamw_on_cuda_tensors_launches_or_raises(monkeypatch):
    from repro_torch.kernels.fused_adamw import fused_adamw_flat

    class Refused(Exception):
        pass

    def refuse():
        raise Refused

    monkeypatch.setattr(build, "load_library", refuse)
    before = fused_adamw_flat.launches
    t = [torch.zeros(64).as_subclass(_CudaLooking) for _ in range(4)]
    sc = torch.ones(3).as_subclass(_CudaLooking)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    with pytest.raises(Refused):
        fused_adamw_flat(*t, sc, **kw)
    g16 = torch.zeros(64, dtype=torch.float16).as_subclass(_CudaLooking)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_adamw_flat(g16, *t[1:], sc, **kw)
    with pytest.raises(ValueError, match="scalars"):
        fused_adamw_flat(*t, torch.ones(4).as_subclass(_CudaLooking), **kw)
    assert fused_adamw_flat.launches == before


def test_flash_on_misaligned_cuda_tensors_raises_before_the_build(
        monkeypatch):
    """The kernel copies 16-byte chunks: a q, k or v that is not 16-byte
    aligned is refused with a ValueError before the library is loaded,
    and nothing is counted as launched."""
    class Refused(Exception):
        pass

    def refuse():
        raise Refused

    monkeypatch.setattr(build, "load_library", refuse)
    before = flash_attention_fwd.launches

    def cuda_view(shape, offset):
        n = int(np.prod(shape))
        flat = torch.zeros(n + offset, dtype=torch.bfloat16)
        return flat[offset:].view(shape).as_subclass(_CudaLooking)

    q, kv = cuda_view((1, 16, 8, 16), 0), cuda_view((1, 16, 2, 16), 0)
    with pytest.raises(Refused):          # aligned: on to the build
        flash_attention_fwd(q, kv, kv)
    for args in ((cuda_view((1, 16, 8, 16), 1), kv, kv),
                 (q, cuda_view((1, 16, 2, 16), 4), kv),
                 (q, kv, cuda_view((1, 16, 2, 16), 3))):
        assert args[0].is_contiguous()
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention_fwd(*args)
    assert flash_attention_fwd.launches == before == 0
