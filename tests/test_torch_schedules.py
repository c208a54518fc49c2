"""The port's schedule IR, generators and task-table compiler against the
JAX package's: the same tasks, the same ``TaskTable.arrays()`` (every
column) and the same ring depths, with the synchronous and the
double-buffered wire, for every registered generator at its default
keywords (the sequence-chunked ones at ``n_seq=2``; their other
variants are in ``tests/test_torch_seqpipe.py``).  Whole-sequence
schedules carry no ``seq`` and an empty KV-carry column."""
import numpy as np
import pytest

from repro.core.schedules import REGISTRY as JAX_REGISTRY
from repro.core.schedules import get_schedule as jax_get_schedule
from repro.core.tasktable import build_task_table as jax_build_task_table
from repro_torch.core.placement import get_placement
from repro_torch.core.schedules import REGISTRY, get_schedule
from repro_torch.core.tasktable import build_task_table, validate_table
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

PORTED = ("gpipe", "1f1b", "interleaved", "chronos", "chronos_recomp",
          "chronos_zero2", "zb_h1", "chronos_zb", "v_min", "v_half", "v_zb",
          "seq1f1b", "chronos_seq")
# generators without a v argument (v=1, or the V-shape family's fixed v=2)
V1 = ("gpipe", "1f1b", "zb_h1", "v_min", "v_half", "v_zb", "seq1f1b")
SIZES = ((2, 4, 2), (4, 8, 2))           # (P, m, v)


def _both(name, P, m, v):
    kw = {} if name in V1 else {"v": v}
    return get_schedule(name, P, m, **kw), jax_get_schedule(name, P, m, **kw)


def _task_tuples(sched):
    return sorted((t.kind, t.mb, t.chunk, t.stage, t.seq, t.start, t.dur,
                   t.recomp, t.comm) for t in sched.tasks)


def test_registry_is_the_ported_generators():
    assert sorted(REGISTRY) == sorted(PORTED) == sorted(JAX_REGISTRY)
    for name in PORTED:
        assert f"``{name}``" in get_schedule.__doc__


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "P%d-m%d-v%d" % s)
@pytest.mark.parametrize("name", PORTED)
def test_schedule_and_table_match_jax(name, size):
    P, m, v = size
    ours, ref = _both(name, P, m, v)
    assert (ours.name, ours.P, ours.v, ours.m, ours.f, ours.b, ours.w,
            ours.n_seq) == (ref.name, ref.P, ref.v, ref.m, ref.f, ref.b,
                            ref.w, ref.n_seq)
    assert ours.pl.name == ref.pl.name
    if ref.n_seq == 1:
        assert all(t.seq == 0 for t in ref.tasks)
    assert _task_tuples(ours) == _task_tuples(ref)
    assert ours.stored_frac == ref.stored_frac
    assert ours.bubble_ratio() == ref.bubble_ratio()
    assert ours.peak_activation() == ref.peak_activation()
    for overlap in (False, True):
        tab = build_task_table(ours, overlap=overlap)
        jtab = jax_build_task_table(ref, overlap=overlap)
        validate_table(tab)
        ours_a, ref_a = tab.arrays(), jtab.arrays()
        np.testing.assert_array_equal(ours_a, ref_a)
        if ref.n_seq == 1:
            # the seq and KV-slot columns carry nothing here
            assert (ours_a[..., 14] == 0).all()
            assert (ours_a[..., 15] == -1).all() and tab.kv_depth == {}
        assert (tab.T, tab.fq_depth, tab.bq_depth, tab.overlap,
                tab.placement_name) == (jtab.T, jtab.fq_depth,
                                        jtab.bq_depth, jtab.overlap,
                                        jtab.placement_name)
        for depths in ("act_depth", "wstash_depth", "rmt_depth",
                       "kv_depth"):
            assert getattr(tab, depths) == getattr(jtab, depths), depths
        assert (tab.has_w, tab.has_r) == (jtab.has_w, jtab.has_r)


def test_chronos_zb_table_depths_at_p4_m8():
    """The configuration the card trains: T=57 ticks, activation ring
    depths {0: 5, 1: 2}, W-stash depths {0: 1, 1: 1}."""
    tab = build_task_table(get_schedule("chronos_zb", 4, 8, v=2))
    assert (tab.T, tab.act_depth, tab.wstash_depth) == \
        (57, {0: 5, 1: 2}, {0: 1, 1: 1})


def test_unknown_schedule_and_placement_raise():
    with pytest.raises(ValueError, match="registered schedules"):
        get_schedule("v_max", 2, 4)
    with pytest.raises(ValueError, match="unknown placement"):
        get_placement("zigzag", 2, 2)
    assert get_placement("interleaved", 4, 2).block(3, 1) == 7
