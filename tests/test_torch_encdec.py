"""whisper-base (the encoder-decoder) in the port against the JAX package
on the CPU: the config, the bridged tree with its encoder leaves,
``LM.loss`` and every gradient (the encoder's included), the pipeline
executor's gradients with the encoder output riding the payload and its
cotangent summed on the backward rings, and the single-host
``prefill(frame_embeds=)`` / ``decode_step`` streams, whose decode reads
the cached cross K/V."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import LM as JaxLM
from repro_torch.bridge import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.pipeline_runtime import make_pipeline_spec
from repro_torch.models import LM
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves
from helpers.torch_pairs import (GRAD_TOL, LOGIT_TOL, LOSS_TOL, PIPE_TOL,
                                 loss_pair, pipeline_pair, planner_pair,
                                 rel, stream_pair)
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "whisper-base"


def test_config_and_counts_match_jax():
    """Every field, ``param_count`` (the encoder and the decoder's
    cross-attention counted) and ``active_param_count``."""
    for ours, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_reduced(ARCH), jax_get_reduced(ARCH))):
        mine = dataclasses.asdict(ours)
        assert {k: dataclasses.asdict(ref)[k] for k in mine} == mine
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() == ref.active_param_count()
    assert get_config(ARCH).param_count() == 97165312


def test_tree_crosses_with_its_encoder():
    """The JAX tree (``encoder`` layers, ``enc_norm``, each decoder
    layer's ``cross`` and ``norm_x``) crosses bitwise and has the port's
    own ``LM.init`` structure, shapes and dtypes, leaf for leaf."""
    tree = jax.tree.map(np.asarray, JaxLM(jax_get_reduced(ARCH)).init(
        jax.random.key(0))[0])
    bridged = lm_params_from_numpy(tree, "cpu")
    own = LM(get_reduced(ARCH), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert len(own["encoder"]) == 2 and "enc_norm" in own
    assert {"cross", "norm_x"} <= set(own["layers"][0])
    a, b = tree_leaves(bridged), tree_leaves(own)
    assert len(a) == len(b) == len(jax.tree.leaves(tree))
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
    for x, y in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(lm_params_to_numpy(bridged))):
        assert x.tobytes() == y.tobytes()


def test_lm_loss_with_encoder_matches_jax():
    """``LM.loss`` over 64 frames and 40 tokens, and every gradient: the
    encoder's, the cross-attention's and the decoder's."""
    e_loss, e_grad, n = loss_pair(get_reduced(ARCH), jax_get_reduced(ARCH))
    print(f"loss |d| {e_loss:.2e}, grads rel {e_grad:.2e} over {n} leaves")
    assert e_loss <= LOSS_TOL and e_grad <= GRAD_TOL


@pytest.mark.parametrize("schedule,v,P,layers", [
    ("chronos_zb", 2, 2, 2), ("1f1b", 1, 2, 2), ("chronos_zb", 2, 3, 6),
    ("chronos", 2, 3, 6)])
def test_pipeline_grads_with_encoder_match_jax(schedule, v, P, layers):
    """P=2 or 3, m=4: the first chunk runs the encoder, ``enc`` rides
    every ring, and each backward chunk adds its cross-attention's
    ``enc`` cotangent to the one it received; every encoder leaf is held
    against ``jax.grad``, and each has a gradient.  At P=3 over 6 layers
    (one a block, as the full config) a device forwards ``enc`` in the
    tick its receive slot takes the next microbatch's."""
    e_loss, e_grad, ours, ref = pipeline_pair(
        dataclasses.replace(get_reduced(ARCH), num_layers=layers),
        dataclasses.replace(jax_get_reduced(ARCH), num_layers=layers),
        schedule, v, P=P, mbB=1)
    n_enc = len(tree_leaves(ours["encoder"])) + 1        # + enc_norm
    enc = tree_leaves(ours["enc_norm"]) + tree_leaves(ours["encoder"])
    k = len(tree_leaves(ours["embed"]))  # sorted: embed, enc_norm, encoder
    ref_enc = ref[k:k + n_enc]
    e_enc = max(rel(a, c) for a, c in zip(enc, ref_enc))
    print(f"{schedule}: loss |d| {e_loss:.2e}, grads rel {e_grad:.2e}, "
          f"encoder grads rel {e_enc:.2e} over {n_enc} leaves")
    assert all(float(a.abs().max()) > 0 for a in enc)
    assert e_loss <= LOSS_TOL and e_grad <= PIPE_TOL and e_enc <= PIPE_TOL


def test_prefill_with_frames_and_decode_reuse_cross_kv():
    """Greedy tokens equal and fp32 logits within 1e-4 of JAX's:
    ``prefill(frame_embeds=)`` over 64 frames and 12 tokens caches every
    layer's cross K/V, and the 5 decode steps read them (the encoder
    cannot run once the prefill is done)."""
    def no_encoder(lm, cache):
        for c in cache["periods"]:
            assert float(c["xk"].abs().max()) > 0
            assert float(c["xv"].abs().max()) > 0

        def refuse(*a, **k):
            raise AssertionError("decode ran the encoder")
        T.encode = refuse

    encode = T.encode
    try:
        got, want, worst = stream_pair(
            get_reduced(ARCH), jax_get_reduced(ARCH), prompt_len=12,
            n_new=6, max_seq=32, between=no_encoder)
    finally:
        T.encode = encode
    print(f"streams {got} / {want}, logits |d| {worst:.2e}")
    assert got == want and worst <= LOGIT_TOL


def test_memory_model_and_planner_match_jax():
    planner_pair(get_config(ARCH), jax_get_config(ARCH))


def test_seq_executor_refuses_the_encoder():
    with pytest.raises(ValueError, match="dense attention"):
        make_pipeline_spec(get_reduced(ARCH), P=2, v=2, m=4, microbatch=1,
                           seq_len=17, schedule="chronos_seq", n_seq=2)
