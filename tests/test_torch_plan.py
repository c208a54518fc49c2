"""The port's memory-budget planner (``repro_torch.plan``) against the JAX
package's (``repro.plan``), on the CPU.  The planner is host arithmetic,
so every pair is exact: the evaluated points field by field and in the
same order, the pick, its error text, the elastic re-plan and the plan
it emits.  Then a pick trains through ``train_pipeline(device="cpu")``.

Queries: the reference's paper query (``tests/test_plan.py``, llama70b at
48 layers, PP8/TP8, 32 GB, its calibration constant read from
``benchmarks.common``) and the one-card queries: P = 4 virtual stages
sharing one 80 GB card (85.0e9 / 4 bytes each), one sequence of 2049
tokens per microbatch, for tinyllama-1.1b, mamba2-2.7b and deepseek-7b
at 24 and 30 layers."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.llama70b_paper import \
    with_layers as jax_with_layers  # noqa: E402
from repro.plan import (ExecutablePlan as JaxExecutablePlan,  # noqa: E402
                        PlannerQuery as JaxPlannerQuery)
from repro.plan import enumerate_points as jax_enumerate_points  # noqa: E402
from repro.plan import plan_under_budget as jax_plan  # noqa: E402
from repro.plan import replan_for_pp as jax_replan  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import (OptimizerConfig,  # noqa: E402
                                      ShapeConfig, TrainConfig)
from repro_torch.configs.llama70b_paper import with_layers  # noqa: E402
from repro_torch.core.pipeline_runtime import \
    init_pipeline_params  # noqa: E402
from repro_torch.launch.steps import make_pipeline_train_step  # noqa: E402
from repro_torch.launch.train import train_pipeline  # noqa: E402
from repro_torch.plan import (ExecutablePlan, PlannerQuery,  # noqa: E402
                              enumerate_points, plan_under_budget,
                              replan_for_pp)
from repro_torch.tree import tree_leaves  # noqa: E402
from helpers.torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

ONE_CARD = dict(pp=4, tp=1, hbm_bytes=85.0e9 / 4, microbatch=1,
                seq_len=2049)
QUERIES = ("paper", "tinyllama-1.1b", "mamba2-2.7b", "deepseek-7b-24",
           "deepseek-7b-30")
# the picks of the one-card queries (tests pin them below)
PICKS = {"tinyllama-1.1b": "v_zb(v=2)", "mamba2-2.7b": "v_zb(v=2)",
         "deepseek-7b-24": "chronos_seq(v=2)+s=4+rc=1+offload=1/2",
         "deepseek-7b-30": "chronos_recomp(v=3)+rc=2+offload=2/3"}


def _cfgs(name):
    if name == "paper":
        return with_layers(48), jax_with_layers(48)
    arch, _, layers = name.partition("-7b-")
    if layers:
        arch += "-7b"
    ours, ref = get_config(arch), jax_get_config(arch)
    if layers:
        ours = dataclasses.replace(ours, num_layers=int(layers))
        ref = dataclasses.replace(ref, num_layers=int(layers))
    return ours, ref


def _kw(name):
    if name == "paper":
        from benchmarks.common import PAPER_ACT_SCALE
        return dict(pp=8, tp=8, hbm_bytes=32e9, reserve=1e9,
                    act_scale=PAPER_ACT_SCALE)
    return dict(ONE_CARD)


def _queries(name):
    ours, ref = _cfgs(name)
    kw = _kw(name)
    return PlannerQuery(cfg=ours, **kw), JaxPlannerQuery(cfg=ref, **kw)


def _fields(point):
    return dataclasses.astuple(point)


@pytest.mark.parametrize("name", QUERIES)
def test_enumerate_points_match_jax(name):
    q, jq = _queries(name)
    pts, ref = enumerate_points(q), jax_enumerate_points(jq)
    assert [f.name for f in dataclasses.fields(pts[0])] == \
        [f.name for f in dataclasses.fields(ref[0])]
    assert len(pts) == len(ref)
    if name != "paper":
        assert len(pts) == 40
    for a, b in zip(pts, ref):
        assert _fields(a) == _fields(b)
        assert a.describe() == b.describe()
        assert a.offload_frac == b.offload_frac


@pytest.mark.parametrize("name", QUERIES)
def test_plan_under_budget_matches_jax(name):
    ours, ref = _cfgs(name)
    kw = _kw(name)
    ep, jep = plan_under_budget(ours, **kw), jax_plan(ref, **kw)
    assert _fields(ep.point) == _fields(jep.point)
    assert ep.m == jep.m == 4 * kw["pp"]
    assert ep.summary() == jep.summary()
    if name in PICKS:
        assert ep.point.describe() == PICKS[name]
    tab, jtab = ep.task_table(), jep.task_table()
    assert tab.name == jtab.name
    np.testing.assert_array_equal(tab.op, jtab.op)
    np.testing.assert_array_equal(tab.mb, jtab.mb)
    np.testing.assert_array_equal(tab.chunk, jtab.chunk)


@pytest.mark.parametrize("arch,hbm", [("deepseek-7b", 10e9),
                                      ("tinyllama-1.1b", 1e9)])
def test_nothing_fits_raises_as_jax(arch, hbm):
    with pytest.raises(ValueError) as got:
        plan_under_budget(get_config(arch), pp=4, tp=1, hbm_bytes=hbm)
    with pytest.raises(ValueError) as want:
        jax_plan(jax_get_config(arch), pp=4, tp=1, hbm_bytes=hbm)
    assert str(got.value) == str(want.value)
    assert "no schedule fits" in str(got.value)


@pytest.mark.parametrize("new_pp", [1, 2, 3, 8])
def test_replan_for_pp_matches_jax(new_pp):
    q, jq = _queries("deepseek-7b-24")
    ep = ExecutablePlan(q, enumerate_points(q)[0], m=12)
    jep = JaxExecutablePlan(jq, jax_enumerate_points(jq)[0], m=12)
    if new_pp == 1:
        with pytest.raises(ValueError) as got:
            replan_for_pp(ep, new_pp)
        with pytest.raises(ValueError) as want:
            jax_replan(jep, new_pp)
        head = "no schedule enumerable at pp=1 for deepseek-7b"
        assert str(got.value).startswith(head)
        assert str(want.value).startswith(head)
        return
    try:
        new, jnew = replan_for_pp(ep, new_pp), jax_replan(jep, new_pp)
    except ValueError as e:
        with pytest.raises(ValueError) as want:
            jax_replan(jep, new_pp)
        assert str(e) == str(want.value)
        return
    assert _fields(new.point) == _fields(jnew.point)
    assert new.m == jnew.m == 12
    assert new.query.pp == new_pp


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "deepseek-7b-24"])
def test_parallel_plan_maps_every_point(name):
    """The port's plan equals the reference's on every field it has
    (``zero_stage`` too, at each of the stages 0-3 it runs); the mesh
    axis name it has not, and a stage past 3, raise."""
    q, jq = _queries(name)
    for p, jp in zip(enumerate_points(q), jax_enumerate_points(jq)):
        pp_ = ExecutablePlan(q, p).parallel_plan()
        ref = JaxExecutablePlan(jq, jp).parallel_plan()
        mine = dataclasses.asdict(pp_)
        theirs = dataclasses.asdict(ref)
        assert mine.pop("kernels") == "fused"
        assert {k: theirs[k] for k in mine} == mine, p.describe()
        assert set(theirs) - set(mine) >= {"pp_axis"}
        assert mine["zero_stage"] == theirs["zero_stage"] == 1
    ep = ExecutablePlan(q, enumerate_points(q)[0])
    pp0 = ep.parallel_plan(microbatch_size=3, zero_stage=0, kernels="plain")
    assert pp0.microbatch_size == 3 and pp0.zero_stage == 0
    with pytest.raises(ValueError, match="virtual"):
        ep.parallel_plan(pp_axis="pod")
    jep = JaxExecutablePlan(jq, jax_enumerate_points(jq)[0])
    for z in (2, 3):
        assert ep.parallel_plan(zero_stage=z).zero_stage == \
            jep.parallel_plan(zero_stage=z).zero_stage == z
    with pytest.raises(ValueError, match="zero_stage=4"):
        ep.parallel_plan(zero_stage=4)


def _train_pick(cfg, describe, P=2, steps=2):
    q = PlannerQuery(cfg=cfg, pp=P, tp=1, hbm_bytes=1e12, microbatch=1,
                     seq_len=41)
    point = next(p for p in enumerate_points(q) if p.describe() == describe)
    ep = ExecutablePlan(q, point)
    plan = ep.parallel_plan()
    tc = TrainConfig(model=cfg, shape=ShapeConfig("t", 41, ep.m, "train"),
                     plan=plan, optimizer=OptimizerConfig(
                         warmup_steps=1, total_steps=steps), log_every=100)
    spec = make_pipeline_train_step(cfg, tc.shape, plan, tc.optimizer, P=P,
                                    device="cpu")[3]
    params = init_pipeline_params(torch.Generator().manual_seed(0), cfg,
                                  spec.layout, "cpu")
    before = [a.clone() for a in _block_leaves(params)]
    out = train_pipeline(tc, P=P, device="cpu", params=params,
                         log=lambda s: None)
    return out, before


def _block_leaves(params):
    return tree_leaves(params["blocks"])


@pytest.mark.parametrize("arch,pick", [
    ("deepseek-7b", PICKS["deepseek-7b-24"]),
    ("deepseek-7b", PICKS["deepseek-7b-30"]),
    ("qwen2-72b", "v_zb(v=2)"),
    ("tinyllama-1.1b", "1f1b+R=50%"),
    ("tinyllama-1.1b", "chronos_zero2(v=2)+offload=1/2")])
def test_planner_pick_trains_on_cpu(arch, pick):
    """A planner point, emitted as a ParallelPlan, trains 2 steps through
    ``train_pipeline`` unchanged (reduced config, fp32, P=2): finite
    losses that fall, every block leaf moved (the offloaded ones by the
    host optimizer)."""
    out, before = _train_pick(get_reduced(arch), pick)
    assert out["steps"] == 2
    assert all(np.isfinite(out["losses"])) and all(
        np.isfinite(out["grad_norms"]))
    assert out["losses"][1] < out["losses"][0]
    for a, b in zip(_block_leaves(out["params"]), before):
        assert not torch.equal(a, b)


def test_seq_pick_on_ssm_raises_as_jax():
    """The planner enumerates sequence-chunked points for any model; on
    one with SSM layers the executor refuses them, as the reference's
    ``make_pipeline_spec`` asserts."""
    with pytest.raises(ValueError, match="dense attention"):
        _train_pick(get_reduced("mamba2-2.7b"), "chronos_seq(v=2)+s=2",
                    steps=1)
