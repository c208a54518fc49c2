"""The port's kernel wrappers (on CPU tensors: their plain versions) against
the JAX package's Pallas kernels in interpret mode and its ``ref.py``
oracles.  Inputs are made with numpy from a seed and handed to both.

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
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention_fwd)
from repro_torch.kernels.rmsnorm import (rmsnorm_fused, rmsnorm_rows,
                                         rmsnorm_rows_ref)

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
