"""paligemma-3b (the VLM patch prefix) in the port against the JAX
package on the CPU: the config, the flash forward at head dim 256 (the
wrapper's plain version against the Pallas kernel in interpret mode),
``LM.loss`` and every gradient with the patch prefix (also at head dim
256), the pipeline executor's gradients with the prefix in the payload,
and the single-host ``prefill(patch_embeds=)`` / ``decode_step``
streams."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels.flash_attention.kernel import \
    flash_attention_fwd as jax_flash_fwd
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.pipeline_runtime import make_pipeline_spec
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention_fwd
from helpers.torch_pairs import (GRAD_TOL, LOGIT_TOL, LOSS_TOL, PIPE_TOL,
                                 loss_pair, pipeline_pair, planner_pair,
                                 stream_pair)
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "paligemma-3b"
FLASH_TOL = 1e-5


def test_config_and_counts_match_jax():
    """Every field, ``param_count`` and ``active_param_count``, full
    width and reduced."""
    for ours, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_reduced(ARCH), jax_get_reduced(ARCH))):
        mine = dataclasses.asdict(ours)
        assert {k: dataclasses.asdict(ref)[k] for k in mine} == mine
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() == ref.active_param_count()
    assert get_config(ARCH).param_count() == 2508660736


# (Sq, Sk, H, G, q_offset, prefix): the training shape's masks (a causal
# prefix over the whole sequence) and a prefill chunk at an offset
FLASH_D256 = [(40, 40, 4, 1, 0, 16), (24, 72, 2, 2, 48, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,H,G,q_offset,prefix", FLASH_D256)
def test_flash_d256_matches_pallas(Sq, Sk, H, G, q_offset, prefix, dtype):
    """Head dim 256 with the causal prefix-LM mask: o within FLASH_TOL
    (fp32) or one bf16 step (2^-7 relative; both round o once from fp32),
    lse within FLASH_TOL; nothing launched."""
    rng = np.random.default_rng(Sq + Sk)
    q = rng.standard_normal((1, Sq, H, 256)).astype(np.float32)
    k = rng.standard_normal((1, Sk, G, 256)).astype(np.float32)
    v = rng.standard_normal((1, Sk, G, 256)).astype(np.float32)
    o, lse = flash_attention_fwd(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        causal=True, prefix=prefix, q_offset=q_offset)
    o_j, lse_j = jax_flash_fwd(
        *(jnp.asarray(a, dtype=dtype) for a in (q, k, v)), causal=True,
        window=0, prefix=prefix, q_offset=q_offset, interpret=True)
    o_j = np.asarray(o_j.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(o.numpy(), o_j, atol=FLASH_TOL, rtol=0)
    else:
        np.testing.assert_allclose(o.float().numpy(), o_j, atol=1e-6,
                                   rtol=2.0 ** -7)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                               atol=FLASH_TOL, rtol=0)
    assert flash_attention_fwd.launches == 0


class _CudaLooking(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_wrapper_takes_d256_and_refuses_other_dims(monkeypatch):
    """A CUDA-looking q at head dim 256 goes on to the build (stubbed to
    fail); 96 and 512 are refused with a ValueError before it."""
    class Refused(Exception):
        pass

    def refuse():
        raise Refused

    monkeypatch.setattr(build, "load_library", refuse)

    def args(d):
        return (torch.zeros((1, 16, 4, d)).as_subclass(_CudaLooking),
                torch.zeros((1, 16, 1, d)).as_subclass(_CudaLooking),
                torch.zeros((1, 16, 1, d)).as_subclass(_CudaLooking))
    with pytest.raises(Refused):
        flash_attention_fwd(*args(256), prefix=8)
    for d in (96, 512):
        with pytest.raises(ValueError, match="head dim"):
            flash_attention_fwd(*args(d))
    assert flash_attention_fwd.launches == 0


@pytest.mark.parametrize("head_dim", [32, 256])
def test_lm_loss_with_patch_prefix_matches_jax(head_dim):
    """``LM.loss`` with 16 patch embeddings ahead of 40 tokens (the patch
    positions dropped before the head) and every gradient, at the reduced
    head dim and at paligemma's 256."""
    cfg = dataclasses.replace(get_reduced(ARCH), head_dim=head_dim)
    jcfg = dataclasses.replace(jax_get_reduced(ARCH), head_dim=head_dim)
    e_loss, e_grad, n = loss_pair(cfg, jcfg)
    print(f"hd {head_dim}: loss |d| {e_loss:.2e}, grads rel {e_grad:.2e} "
          f"over {n} leaves")
    assert e_loss <= LOSS_TOL and e_grad <= GRAD_TOL


@pytest.mark.parametrize("schedule,v", [("chronos_zb", 2), ("1f1b", 1)])
def test_pipeline_grads_with_patch_prefix_match_jax(schedule, v):
    """P=2, m=4: the patches enter with the first chunk's embedding, every
    chunk attends with the prefix-LM mask, the head drops them."""
    e_loss, e_grad, _, _ = pipeline_pair(get_reduced(ARCH),
                                         jax_get_reduced(ARCH), schedule, v)
    print(f"{schedule}: loss |d| {e_loss:.2e}, grads rel {e_grad:.2e}")
    assert e_loss <= LOSS_TOL and e_grad <= PIPE_TOL


def test_prefill_with_patches_and_decode_match_jax():
    """Greedy tokens equal and fp32 logits within 1e-4 of JAX's:
    ``prefill(patch_embeds=)`` over 16 patches and 20 tokens, then 5
    decode steps."""
    got, want, worst = stream_pair(get_reduced(ARCH), jax_get_reduced(ARCH),
                                   prompt_len=20, n_new=6, max_seq=48)
    print(f"streams {got} / {want}, logits |d| {worst:.2e}")
    assert got == want and worst <= LOGIT_TOL


def test_memory_model_and_planner_match_jax():
    """``MemoryModel``, ``max_trainable_layers`` and ``plan_under_budget``
    at full width (:func:`helpers.torch_pairs.planner_pair`)."""
    planner_pair(get_config(ARCH), jax_get_config(ARCH))


def test_seq_executor_refuses_the_patch_prefix():
    with pytest.raises(ValueError, match="dense attention"):
        make_pipeline_spec(get_reduced(ARCH), P=2, v=2, m=4, microbatch=1,
                           seq_len=17, schedule="chronos_seq", n_seq=2)
