"""The port's analytic layer against the JAX package's, on the CPU: the
dense configs the planner reads, the paper's closed forms, the five
``Schedule`` methods the planner calls, the executor's tick-cost model,
the byte-level ``MemoryModel`` and ``max_trainable_layers``.  All of it
is host arithmetic, so every pair is exact (``==`` on floats)."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.core import analysis as JA
from repro.core.schedules import get_schedule as jax_get_schedule
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core import analysis as TA
from repro_torch.core.schedules import REGISTRY, get_schedule
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("tinyllama-1.1b", "mamba2-2.7b", "deepseek-7b", "qwen2-72b",
         "llama70b-paper", "qwen2-moe-a2.7b", "grok-1-314b",
         "jamba-v0.1-52b", "gemma3-27b", "paligemma-3b", "whisper-base")
V1 = ("gpipe", "1f1b", "zb_h1", "v_min", "v_half", "v_zb", "seq1f1b")
SIZES = ((2, 4), (4, 8))                # (P, m); v = 2 where it applies
GRID_P = (2, 3, 4, 6, 8, 16)
GRID_M = (1, 2, 4, 8, 32)
GRID_TC = (0.0, 0.5, 1.0, 2.0)


def _pair(name, P, m):
    kw = {} if name in V1 else {"v": 2}
    return get_schedule(name, P, m, **kw), jax_get_schedule(name, P, m, **kw)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registered_archs():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS) == {
        "tinyllama-1.1b", "mamba2-2.7b", "deepseek-7b", "qwen2-72b",
        "qwen2-moe-a2.7b", "grok-1-314b", "jamba-v0.1-52b", "gemma3-27b",
        "paligemma-3b", "whisper-base"}
    get_config("llama70b-paper")          # registered, not an ARCH_ID
    from repro_torch.configs.llama70b_paper import with_layers
    from repro.configs.llama70b_paper import with_layers as jax_with_layers
    assert dataclasses.asdict(with_layers(48)).items() <= \
        dataclasses.asdict(jax_with_layers(48)).items()


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, reduced):
    """Every field of the port's config equals the reference's, and so
    do ``param_count``, ``active_param_count`` and ``layer_is_moe``."""
    get = (get_reduced, jax_get_reduced) if reduced else \
        (get_config, jax_get_config)
    ours, ref = get[0](arch), get[1](arch)
    mine = dataclasses.asdict(ours)
    theirs = dataclasses.asdict(ref)
    assert {k: theirs[k] for k in mine} == mine
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    assert [ours.layer_is_moe(i) for i in range(ours.num_layers)] == \
        [ref.layer_is_moe(i) for i in range(ref.num_layers)]


# ---------------------------------------------------------------------------
# closed forms
# ---------------------------------------------------------------------------

CLOSED = {
    "chronos_peak_frac": lambda f, P, m, tc: f(P),
    "chronos_recomp_peak_frac": lambda f, P, m, tc: f(P),
    "chronos_bubble": lambda f, P, m, tc: f(P, m, tc),
    "onef1b_bubble": lambda f, P, m, tc: f(P, m, tc),
    "zb_h1_bubble": lambda f, P, m, tc: f(P, m, 1.0, 1.0 + tc, 1.0),
    "v_min_bubble_bound": lambda f, P, m, tc: f(P, m),
    "vshape_zb_bubble": lambda f, P, m, tc: f(P, m, 1.0 + tc, 1.0, 1.0),
}


@pytest.mark.parametrize("name", sorted(CLOSED))
def test_closed_form_matches_jax(name):
    call = CLOSED[name]
    for P, m, tc in itertools.product(GRID_P, GRID_M, GRID_TC):
        assert call(getattr(TA, name), P, m, tc) == \
            call(getattr(JA, name), P, m, tc), (P, m, tc)


# ---------------------------------------------------------------------------
# Schedule methods and the tick-cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: "P%d-m%d" % s)
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_schedule_methods_match_jax(name, size):
    ours, ref = _pair(name, *size)

    def keyed(tasks):
        return [(t.key(), t.start, t.dur) for t in tasks]
    bk, rbk = ours.by_key(), ref.by_key()
    assert sorted(bk) == sorted(rbk)
    assert all((bk[k].start, bk[k].dur) == (rbk[k].start, rbk[k].dur)
               for k in bk)
    for d in range(ours.P):
        assert keyed(ours.device_tasks(d)) == keyed(ref.device_tasks(d))
        assert ours.warmup_cooldown_bubbles(d) == \
            ref.warmup_cooldown_bubbles(d)
    assert ours.warmup_cooldown_bubbles() == ref.warmup_cooldown_bubbles()
    assert ours.total_time_rel() == ref.total_time_rel()
    assert ours.ideal_compute_fraction() == ref.ideal_compute_fraction()


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_predicted_tick_costs_match_jax(name):
    ours, ref = _pair(name, 4, 8)
    got, want = TA.predicted_tick_costs(ours), JA.predicted_tick_costs(ref)
    np.testing.assert_array_equal(got, want)
    for d in range(4):
        for c in range(ours.v):
            assert TA._stage_of(ours, d, c) == JA._stage_of(ref, d, c)


# ---------------------------------------------------------------------------
# MemoryModel and max_trainable_layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_memory_model_matches_jax(arch, tp):
    ours = TA.MemoryModel.build(get_config(arch), tp=tp)
    ref = JA.MemoryModel.build(jax_get_config(arch), tp=tp)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for tokens, L in ((2049, 24), (8192, 80)):
        assert ours.m_a(tokens, L) == ref.m_a(tokens, L)
        assert ours.kv_a(tokens, L) == ref.kv_a(tokens, L)
    for pp, frac, dp in itertools.product((1, 4, 8), (0.0, 1 / 3, 0.5),
                                          (1, 2)):
        assert ours.model_state(30, pp, tp, dp_shard=dp,
                                offload_frac=frac) == \
            ref.model_state(30, pp, tp, dp_shard=dp, offload_frac=frac)


@pytest.mark.parametrize("arch", ARCHS)
def test_max_trainable_layers_matches_jax(arch):
    for hbm_gb, pp, tp, frac, off, step in itertools.product(
            (16, 21.25, 80), (4, 8), (1, 8), (0.125, 0.5, 1.0),
            (0.0, 0.5), (1, 8)):
        kw = dict(hbm_bytes=hbm_gb * 1e9, pp=pp, tp=tp,
                  microbatch_tokens=2049, act_frac_of_ma=frac,
                  offload_frac=off, layer_step=step)
        assert TA.max_trainable_layers(get_config(arch), **kw) == \
            JA.max_trainable_layers(jax_get_config(arch), **kw), kw
    mm = TA.MemoryModel.build(get_config(arch))
    jmm = JA.MemoryModel.build(jax_get_config(arch))
    scaled = dict(hbm_bytes=32e9, pp=8, tp=8, microbatch_tokens=8192,
                  act_frac_of_ma=0.5, reserve=1e9)
    assert TA.max_trainable_layers(
        get_config(arch), memory_model=dataclasses.replace(
            mm, act_per_token_layer=2 * mm.act_per_token_layer),
        **scaled) == JA.max_trainable_layers(
        jax_get_config(arch), memory_model=dataclasses.replace(
            jmm, act_per_token_layer=2 * jmm.act_per_token_layer),
        **scaled)


def test_moe_config_raises():
    """The MoE terms of ``MemoryModel`` (the experts' activations, the
    router logits) and of ``param_count`` equal the reference's on an MoE
    layout the registry does not hold (MoE on every third layer, from
    layer 1, beside dense layers); the VLM and encoder-decoder families,
    which ``MemoryModel.build`` used to refuse, build the reference's
    model (paligemma-3b, and whisper-base with its encoder and
    cross-attention terms)."""
    moe = dataclasses.replace(get_config("qwen2-moe-a2.7b").moe,
                              layer_period=3, layer_offset=1)
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), moe=moe)
    jcfg = dataclasses.replace(
        jax_get_config("qwen2-moe-a2.7b"),
        moe=dataclasses.replace(jax_get_config("qwen2-moe-a2.7b").moe,
                                layer_period=3, layer_offset=1))
    assert cfg.period == jcfg.period == 3
    assert [cfg.layer_is_moe(i) for i in range(cfg.num_layers)] == \
        [jcfg.layer_is_moe(i) for i in range(jcfg.num_layers)]
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for tp in (1, 4):
        assert dataclasses.asdict(TA.MemoryModel.build(cfg, tp=tp)) == \
            dataclasses.asdict(JA.MemoryModel.build(jcfg, tp=tp))
    for arch in ("paligemma-3b", "whisper-base"):
        for tp in (1, 4):
            assert dataclasses.asdict(TA.MemoryModel.build(
                get_config(arch), tp=tp)) == dataclasses.asdict(
                JA.MemoryModel.build(jax_get_config(arch), tp=tp))
