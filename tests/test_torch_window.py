"""gemma3-27b (5:1 local/global sliding-window layers, an LM stacked by
periods of 6) in the port against the JAX package on the CPU: the
config, ``LM.loss`` and every gradient over a sequence longer than the
reduced window of 32, the pipeline executor's gradients (per-layer
windows as flags), the single-host streams past the window, and the
engine's packing of the LM's period-6 stack into its period-1 layout
(the engine's streams against JAX are in ``test_torch_serve.py``)."""
import dataclasses

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.layout import StageLayout
from repro_torch.core.placement import Placement
from repro_torch.models import LM
from repro_torch.models.transformer import _index
from repro_torch.serve.engine import pack_blocks
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_pairs import (GRAD_TOL, LOGIT_TOL, LOSS_TOL, PIPE_TOL,
                                 loss_pair, pipeline_pair, planner_pair,
                                 stream_pair)
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "gemma3-27b"


def test_config_and_counts_match_jax():
    for ours, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_reduced(ARCH), jax_get_reduced(ARCH))):
        mine = dataclasses.asdict(ours)
        assert {k: dataclasses.asdict(ref)[k] for k in mine} == mine
        assert ours.param_count() == ref.param_count()
        assert [ours.layer_is_global(i) for i in range(ours.num_layers)] \
            == [ref.layer_is_global(i) for i in range(ref.num_layers)]
    assert get_config(ARCH).param_count() == 27008314368
    assert get_config(ARCH).period == 6


def test_lm_loss_past_the_window_matches_jax():
    """40 positions against reduced gemma3's window of 32: the local
    layers mask real keys."""
    cfg = get_reduced(ARCH)
    assert cfg.sliding_window < 40
    e_loss, e_grad, n = loss_pair(cfg, jax_get_reduced(ARCH))
    print(f"loss |d| {e_loss:.2e}, grads rel {e_grad:.2e} over {n} leaves")
    assert e_loss <= LOSS_TOL and e_grad <= GRAD_TOL


@pytest.mark.parametrize("schedule,v", [("chronos_zb", 2), ("1f1b", 1)])
def test_pipeline_grads_past_the_window_match_jax(schedule, v):
    """P=2, m=4, 40 positions: each layer's window rides the layout's
    flags; the unstaged gradients restack into the LM's periods of 6."""
    e_loss, e_grad, _, _ = pipeline_pair(get_reduced(ARCH),
                                         jax_get_reduced(ARCH), schedule, v,
                                         seq=41)
    print(f"{schedule}: loss |d| {e_loss:.2e}, grads rel {e_grad:.2e}")
    assert e_loss <= LOSS_TOL and e_grad <= PIPE_TOL


def test_prefill_and_decode_past_the_window_match_jax():
    got, want, worst = stream_pair(get_reduced(ARCH), jax_get_reduced(ARCH),
                                   prompt_len=40, n_new=6, max_seq=64)
    print(f"streams {got} / {want}, logits |d| {worst:.2e}")
    assert got == want and worst <= LOGIT_TOL


@pytest.mark.parametrize("consume", [False, True])
@pytest.mark.parametrize("P", [1, 2, 3])
def test_pack_blocks_at_gemma3_periods_is_the_plain_stack(P, consume):
    """8 layers (one period of 6 and 2 remainder layers, as the full
    config's 62 are 10 and 2) packed for P stages: each block row equals
    the LM's layer at that global index (zeros for the padding of P=3).
    With ``consume`` every layer leaf leaves the LM tree once packed."""
    cfg = dataclasses.replace(get_reduced(ARCH), num_layers=8)
    lm = LM(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    assert lm.num_periods == 1 and lm.num_rem == 2
    layers = [_index(params["layers"][g % 6], g // 6) if g < 6
              else params["rem_layers"][g - 6] for g in range(8)]
    want = [tree_map(lambda a: a.clone(), t) for t in layers]
    del layers
    layout = StageLayout.build(cfg, P, 1, Placement(P, 1))
    blocks = pack_blocks(lm, params, layout, consume=consume)
    assert len(blocks) == layout.period == 1
    for d in range(P):
        for mi in range(layout.M):
            g = layout.global_idx(d, 0, mi)
            got = tree_map(lambda a: a[d, mi], blocks[0])
            ref = want[g] if g < 8 else tree_map(torch.zeros_like, want[0])
            for a, b in zip(tree_leaves(got), tree_leaves(ref)):
                assert torch.equal(a, b), (P, g)
    left = tree_leaves(params["layers"]) + tree_leaves(params["rem_layers"])
    assert (len(left) == 0) == consume


def test_memory_model_and_planner_match_jax():
    planner_pair(get_config(ARCH), jax_get_config(ARCH))
