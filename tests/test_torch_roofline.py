"""The port's roofline (``repro_torch.roofline``) and one-card dry run
(``repro_torch.launch.dryrun``) against the JAX package's, on the CPU.

- the shapes, the cell rule, ``model_flops_for`` and ``Roofline`` (given
  the reference's peaks) equal the reference's; ``analytic_memory_bytes``
  at ``tp=16`` equals the reference's term times its bandwidth;
- the counted matrix FLOPs of ``LM.loss`` forward and backward equal
  ``analyze_hlo`` of the reference's ``jax.jit(jax.grad(loss))`` through
  an exact reckoning: the reference runs the full-square attention
  forward, the port counts the flash kernel's visible pairs
  (``kernel_cost``) and its plain backward recomputes the full square;
- a whole training step counted on the CPU equals the dry run's count
  on the meta device (each distinct op once, multiplied), FLOPs and
  bytes exactly;
- ``kernel_cost`` gives the Bound column of PERF.md's kernel table;
- each kernel wrapper's meta path returns the plain version's shapes and
  types, and the counting hook counts a call once with its body hidden.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cell_is_skipped as jax_cell_is_skipped
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import LM as JaxLM
from repro.roofline import analysis as JR
from repro.roofline import summarize as JS
from repro_torch.configs import (ARCH_IDS, SHAPES, cell_is_skipped,
                                 get_config, get_reduced, get_shape)
from repro_torch.configs.base import (OffloadConfig, OptimizerConfig,
                                      ParallelPlan, RecomputeConfig,
                                      ShapeConfig)
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention_fwd)
from repro_torch.kernels.fused_adamw import fused_adamw_flat
from repro_torch.kernels.rmsnorm import rmsnorm_rows
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import dryrun
from repro_torch.models import LM
from repro_torch.roofline import analysis as R
from repro_torch.roofline import summarize as S
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FAMILIES = ("tinyllama-1.1b", "mamba2-2.7b", "qwen2-moe-a2.7b")
B, SEQ = 2, 65                    # the JAX pair: 64 positions a sequence
REL = 1e-12                       # float reckonings: rounding only


def _rel(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


# ---------------------------------------------------------------------------
# configs, model FLOPs, Roofline, the analytic memory term
# ---------------------------------------------------------------------------

def test_cells_equal_the_reference():
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert cfg.is_subquadratic == jcfg.is_subquadratic, arch
        for name in SHAPES:
            assert cell_is_skipped(cfg, get_shape(name)) == \
                jax_cell_is_skipped(jcfg, JAX_SHAPES[name]), (arch, name)
            shape = get_shape(name)
            got = R.model_flops_for(cfg, shape, shape.kind)
            assert got == JR.model_flops_for(jcfg, JAX_SHAPES[name],
                                             shape.kind), (arch, name)


def test_roofline_with_the_reference_peaks_is_the_reference():
    rng = np.random.default_rng(0)
    for chips in (1, 256, 512):
        f, b, coll, mf = (float(x) for x in rng.uniform(1e12, 1e16, 4))
        for c in (0.0, coll):
            ref = JR.Roofline(flops=f, bytes_hbm=b, collective_bytes=c,
                              chips=chips, model_flops=mf).as_dict()
            got = R.Roofline(flops=f, bytes_hbm=b, collective_bytes=c,
                             chips=chips, model_flops=mf,
                             peak_flops=JR.PEAK_FLOPS, hbm_bw=JR.HBM_BW,
                             link_bw=JR.LINK_BW).as_dict()
            assert list(got) == list(ref)
            for k in ref:
                assert got[k] == ref[k], k          # the same arithmetic


def test_roofline_defaults_are_the_h100s():
    r = R.Roofline(flops=989e12, bytes_hbm=3.35e12, collective_bytes=450e9,
                   chips=1, model_flops=989e12 / 2)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 1.0, 1.0)
    assert r.useful_ratio == 0.5 and r.roofline_fraction == 0.5
    assert R.mfu(989e12, 2.0) == 0.5
    ms, by = R.bound_ms(989e9, 1.0)
    assert ms == pytest.approx(1.0, rel=REL) and by == "operations"


@pytest.mark.parametrize("chips", (256, 512))
def test_analytic_memory_bytes_at_tp16_are_the_reference(chips):
    for arch in ARCH_IDS:
        for name in SHAPES:
            ref = JS.analytic_memory_term(arch, name, chips, chips == 512)
            got = S.analytic_memory_bytes(arch, name, chips, tp=16)
            assert _rel(got, ref * JS.HBM_BW), (arch, name)
            assert _rel(S.analytic_memory_term(arch, name, chips, tp=16,
                                               hbm_bw=JS.HBM_BW), ref)


# ---------------------------------------------------------------------------
# counted FLOPs against analyze_hlo
# ---------------------------------------------------------------------------

def _attn_layers(cfg):
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))


def _full_square_fwd(cfg, Bz, S):
    """The dense attention forward's dot FLOPs, QK^T and PV over every
    (q, k) pair, all attention layers."""
    H, d = cfg.num_heads, cfg.resolved_head_dim
    return _attn_layers(cfg) * 2 * (2 * Bz * H * S * S * d)


def _port_loss_count(cfg, device="cpu"):
    lm = LM(cfg, kernels="fused", device=device)
    gen = torch.Generator().manual_seed(0) if device == "cpu" else None
    p = tree_map(lambda a: a.detach().requires_grad_(), lm.init(gen))
    tok = torch.zeros((B, SEQ), dtype=torch.int32, device=device)
    with R.count_work() as c:
        loss = lm.loss(p, {"tokens": tok})[0]
        torch.autograd.grad(loss, tree_leaves(p))
    return c


@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "qwen2-moe-a2.7b"))
def test_counted_flops_reconcile_with_analyze_hlo(arch):
    """Exact: port = reference - full-square forward + the kernel's
    visible-pair forward + the plain backward's full-square recompute."""
    jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
    lm = JaxLM(jcfg)
    params, _ = lm.init(jax.random.key(0))
    batch = {"tokens": jnp.zeros((B, SEQ), jnp.int32)}
    hlo = jax.jit(jax.grad(lambda p, b: lm.loss(p, b)[0])).lower(
        params, batch).compile().as_text()
    ref = JR.analyze_hlo(hlo).flops
    S_ = SEQ - 1
    flash = R.kernel_cost(
        "flash_attention_fwd", B=B, Sq=S_, Sk=S_, H=cfg.num_heads,
        G=cfg.num_kv_heads, d=cfg.resolved_head_dim, itemsize=4)[0] \
        * _attn_layers(cfg)
    full = _full_square_fwd(cfg, B, S_)
    want = ref - full + flash + full
    c = _port_loss_count(cfg)
    print(f"{arch}: analyze_hlo {ref:.0f}, reckoned {want:.0f}, counted "
          f"{c.flops}")
    assert c.flops == want
    assert c.kernels["flash_attention_fwd"] == [
        _attn_layers(cfg), flash, c.kernels["flash_attention_fwd"][2]]


# ---------------------------------------------------------------------------
# the CPU count against the meta count
# ---------------------------------------------------------------------------

SHAPE = ShapeConfig("t", 33, 4, "train")
OCFG = OptimizerConfig(warmup_steps=2, total_steps=4)
PIPE = ParallelPlan(schedule="chronos_zb", num_chunks=2, microbatch_size=2,
                    num_microbatches=4, kernels="fused")
MODES = ("none", "chronos", "full")


def _single(mode):
    return ParallelPlan(num_chunks=2, microbatch_size=2,
                        recompute=RecomputeConfig(mode), kernels="fused")


@functools.lru_cache(maxsize=None)
def _count(arch, path, device):
    cfg = get_reduced(arch)
    if path == "pipeline":
        return dryrun.count_pipeline_step(cfg, SHAPE, PIPE, OCFG, 2, device)
    return dryrun.count_single_step(cfg, SHAPE, _single(path), OCFG, device)


@pytest.mark.parametrize("path", ("pipeline",) + MODES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_cpu_count_equals_meta_count(arch, path):
    """FLOPs, bytes (score-class apart) and every kernel's calls, FLOPs
    and bytes exactly: the meta count of the pipeline step runs each
    distinct op once, of train() one and two microbatches."""
    cpu, meta = _count(arch, path, "cpu"), _count(arch, path, "meta")
    assert cpu.flops == meta.flops > 0
    assert (cpu.bytes_traffic, cpu.score_bytes) == \
        (meta.bytes_traffic, meta.score_bytes)
    assert cpu.kernels == meta.kernels
    assert cpu.ops == meta.ops
    kern = {"tinyllama-1.1b": "flash_attention_fwd",
            "mamba2-2.7b": "ssd_scan",
            "qwen2-moe-a2.7b": "flash_attention_fwd"}[arch]
    assert cpu.kernels[kern][0] > 0 and cpu.kernels["rmsnorm_rows"][0] > 0
    # the fused update runs only where the table has W tasks
    assert ("fused_adamw_flat" in cpu.kernels) == (path == "pipeline")


@pytest.mark.parametrize("arch", FAMILIES)
def test_useful_ratio_orders_the_recompute_modes(arch):
    cfg = get_reduced(arch)
    mf = R.model_flops_for(cfg, SHAPE, "train")
    none = R.CollectiveStats({}, {})
    useful = [R.cost_to_roofline(_count(arch, m, "meta"), none, 1,
                                 mf).useful_ratio for m in MODES]
    print(arch, dict(zip(MODES, useful)))
    assert useful[0] > useful[1] > useful[2] > 0


SHAPE8 = ShapeConfig("t8", 33, 8, "train")       # 4 microbatches of 2
# plans whose memoized count the dry run reports: the smoke's
# chronos_zb, its default plan (chronos, Chronos-Recomp of one chunk) and
# what --plan-hbm-gb can pick besides (sequence-chunked schedules, offload)
MEMO_PLANS = {
    "chronos_zb": PIPE,
    "default_plan": dryrun.default_plan(),
    "chronos_seq": ParallelPlan(schedule="chronos_seq", num_chunks=2,
                                seq_chunks=2, microbatch_size=2,
                                kernels="fused"),
    "seq1f1b": ParallelPlan(schedule="seq1f1b", num_chunks=1, seq_chunks=2,
                            microbatch_size=2, kernels="fused"),
    "offload": ParallelPlan(schedule="chronos_zb", num_chunks=2,
                            microbatch_size=2, kernels="fused",
                            offload=OffloadConfig(enabled=True,
                                                  num_offload_chunks=1)),
}


def _same(a, b):
    return (a.flops, a.bytes_traffic, a.score_bytes, a.kernels, a.ops) == \
        (b.flops, b.bytes_traffic, b.score_bytes, b.kernels, b.ops)


@pytest.mark.parametrize("plan", sorted(MEMO_PLANS))
def test_the_dry_run_multiplies_what_a_full_meta_step_counts(plan):
    """The dry run's memoized count of each plan equals the whole step
    counted on meta and on the CPU: FLOPs, bytes, kernels and ops
    exactly."""
    cfg, p = get_reduced("tinyllama-1.1b"), MEMO_PLANS[plan]
    memo = dryrun.count_pipeline_step(cfg, SHAPE8, p, OCFG, 2, "meta")
    step, args, _ = dryrun.build_pipeline(cfg, SHAPE8, p, OCFG, 2, "meta")
    with R.count_work() as full:
        step(*args)
    cpu = dryrun.count_pipeline_step(cfg, SHAPE8, p, OCFG, 2, "cpu")
    assert memo.flops > 0 and memo.kernels["rmsnorm_rows"][0] > 0
    assert _same(memo, full) and _same(memo, cpu)


def test_the_single_step_extension_equals_the_whole_step():
    """train() at 4 microbatches: the meta count (1 and 2 microbatches,
    the difference extended) equals the whole step on the CPU."""
    cfg, p = get_reduced("tinyllama-1.1b"), _single("chronos")
    meta = dryrun.count_single_step(cfg, SHAPE8, p, OCFG, "meta")
    cpu = dryrun.count_single_step(cfg, SHAPE8, p, OCFG, "cpu")
    m2 = _count("tinyllama-1.1b", "chronos", "cpu")      # 2 microbatches
    assert cpu.kernels["flash_attention_fwd"][0] == \
        2 * m2.kernels["flash_attention_fwd"][0] > 0
    assert _same(meta, cpu)


# ---------------------------------------------------------------------------
# kernel_cost: PERF.md's Bound column
# ---------------------------------------------------------------------------

def _flash(Sq, Sk, H, G, d, **kw):
    return R.kernel_cost("flash_attention_fwd", B=1, Sq=Sq, Sk=Sk, H=H, G=G,
                         d=d, itemsize=2, **kw)


def _us(cost, peak=R.PEAK_FLOPS):
    ms, by = R.bound_ms(*cost, peak=peak)
    return ms * 1e3, by


def test_kernel_cost_gives_the_table_bounds():
    """Each figure as PERF.md prints it (ms or us, its digits)."""
    f, b = _flash(2048, 2048, 32, 4, 64)                 # training shape
    assert round(f / 1e9, 2) == 17.19
    assert (round(_us((f, b))[0], 2), _us((f, b))[1]) == (17.38,
                                                          "operations")
    f, b = _flash(2304, 2304, 8, 1, 256, prefix=256)     # paligemma
    assert round(f / 1e9, 2) == 22.02 and round(_us((f, b))[0], 2) == 22.27
    assert R.visible_pairs(2304, 2304, prefix=256) == (2_688_000, 2304)
    assert (round(_us(_flash(64, 512, 32, 4, 64, q_offset=192))[0], 3),
            _us(_flash(64, 512, 32, 4, 64, q_offset=192))[1]) == \
        (0.237, "bytes")
    off = [round(_us(_flash(1024, 2048, 32, 4, 64, q_offset=o))[0], 2)
           for o in (0, 1024)]
    assert off == [4.35, 13.03]
    off = [_us(_flash(512, 2048, 32, 4, 64, q_offset=o))
           for o in (0, 512, 1024, 1536)]
    assert [round(t, 2) for t, _ in off] == [1.43, 3.26, 5.43, 7.60]
    assert [by for _, by in off] == ["bytes"] + ["operations"] * 3
    off = [_us(_flash(512, 2048, 32, 32, 128, q_offset=o))
           for o in (0, 512, 1024, 1536)]
    assert [round(t, 2) for t, _ in off] == [5.03, 7.53, 10.86, 15.20]
    assert [by for _, by in off] == ["bytes", "bytes", "operations",
                                     "operations"]
    n = 4 * 2 * 3 * 2048 * 5632                          # tinyllama's wi
    f, b = R.kernel_cost("fused_adamw_flat", n=n, g_itemsize=4)
    assert round(n / 1e6, 1) == 276.8 and round(b / 1e9, 2) == 7.75
    ms, by = R.bound_ms(f, b, peak=R.PEAK_FLOPS_FP32)
    assert (round(ms, 3), by) == (2.314, "bytes")
    ssd = dict(B=1, H=80, P=64, N=128, Q=128, itemsize=2)
    f, b = R.kernel_cost("ssd_scan", S=2048, **ssd)
    assert round(b / 1e6, 1) == 67.2 and round(_us((f, b))[0], 2) == 20.07
    f, b = R.kernel_cost("ssd_scan", S=128, h0=True, **ssd)
    assert round(b / 1e6, 2) == 9.28 and round(_us((f, b))[0], 2) == 2.77
    table = {(64, 2048): 0.158, (2048, 2048): 5.009, (2048, 2560): 6.262,
             (2048, 5120): 12.523, (512, 4096): 2.507}
    for (Rr, d), us in table.items():
        f, b = R.kernel_cost("rmsnorm_rows", R=Rr, d=d, itemsize=2)
        assert f == 0 and b == (2 * Rr * d + d) * 2
        assert round(_us((f, b))[0], 3) == us, (Rr, d)


def test_visible_pairs_is_attention_refs_mask():
    """Every mask case against the count of ``attention_ref``'s visible
    entries (read off its lse: a row that sees no key has lse at the
    mask value)."""
    cases = [(64, 512, True, 0, 0, 192), (64, 500, True, 128, 16, 436),
             (16, 8, True, 2, 0, 20), (100, 300, True, 64, 16, 200),
             (50, 70, False, 0, 0, 0), (50, 70, False, 16, 8, 10),
             (33, 33, True, 0, 40, 0), (40, 64, True, 8, 0, 0)]
    for Sq, Sk, causal, window, prefix, off in cases:
        q = torch.zeros((1, Sq, 1, 16))
        k = v = torch.zeros((1, Sk, 1, 16))
        _, lse = attention_ref(q, k, v, causal=causal, window=window,
                               prefix=prefix, q_offset=off)
        seen = torch.exp(lse[0, 0]).round()        # visible keys a row
        seen[lse[0, 0] < -1e8] = 0
        pairs, rows = R.visible_pairs(Sq, Sk, causal=causal, window=window,
                                      prefix=prefix, q_offset=off)
        assert pairs == int(seen.sum()), (Sq, Sk, causal, window, prefix)
        assert rows <= Sk


# ---------------------------------------------------------------------------
# the meta paths and the counting hook
# ---------------------------------------------------------------------------

def _like(a, b):
    return a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_wrappers_on_meta_return_the_plain_shapes(dtype):
    g = torch.Generator().manual_seed(0)
    fns = (rmsnorm_rows, flash_attention_fwd, ssd_scan, fused_adamw_flat)
    before = [f.launches for f in fns]

    def both(*shape, dt=dtype):
        x = torch.randn(shape, generator=g).to(dt)
        return x, x.to("meta")

    x, xm = both(7, 100)
    s, sm = both(100)
    assert _like(rmsnorm_rows(xm, sm), rmsnorm_rows(x, s))
    assert rmsnorm_rows(xm, sm).device.type == "meta"
    (q, qm), (k, km), (v, vm) = both(2, 40, 8, 32), both(2, 50, 2, 32), \
        both(2, 50, 2, 32)
    for got, want in zip(flash_attention_fwd(qm, km, vm, q_offset=10),
                         flash_attention_fwd(q, k, v, q_offset=10)):
        assert _like(got, want) and got.device.type == "meta"
    (xs, xsm), (Bc, Bm), (Cc, Cm) = both(2, 32, 4, 16), both(2, 32, 8), \
        both(2, 32, 8)
    (dt, dtm), (A, Am), (h0, h0m) = both(2, 32, 4, dt=torch.float32), \
        both(4, dt=torch.float32), both(2, 4, 16, 8, dt=torch.float32)
    for kw, kwm in (({}, {}), ({"h0": h0}, {"h0": h0m})):
        for got, want in zip(ssd_scan(xsm, Bm, Cm, dtm, Am, chunk=16, **kwm),
                             ssd_scan(xs, Bc, Cc, dt.abs(), -A.abs(),
                                      chunk=16, **kw)):
            assert _like(got, want) and got.device.type == "meta"
    st = [torch.zeros(10, device="meta") for _ in range(3)]
    gm = torch.zeros(10, dtype=dtype, device="meta")
    out = fused_adamw_flat(gm, *st, torch.zeros(3, device="meta"), b1=0.9,
                           b2=0.95, eps=1e-8, wd=0.1)
    assert all(a is b for a, b in zip(out, st))
    assert [f.launches for f in fns] == before   # nothing launched


def test_the_meta_path_serves_only_meta_tensors():
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError):
        rmsnorm_rows(x.to("meta"), torch.ones(16))
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError):
        flash_attention_fwd(q.to("meta"), q, q)


def test_a_counted_call_is_its_kernel_cost_with_its_body_hidden():
    x, s = torch.randn(300, 64), torch.ones(64)
    with R.count_work() as c:
        y = rmsnorm_rows(x, s)
    assert c.kernels == {"rmsnorm_rows": [1, 0, (2 * 300 * 64 + 64) * 4]}
    assert c.ops == {} and c.flops == 0
    assert c.bytes_traffic == (2 * 300 * 64 + 64) * 4
    assert torch.equal(y, rmsnorm_rows(x, s))
    q = torch.randn(1, 64, 4, 16)
    with R.count_work() as c:
        flash_attention_fwd(q, q[:, :, :2], q[:, :, :2], q_offset=0)
    f, b = R.kernel_cost("flash_attention_fwd", B=1, Sq=64, Sk=64, H=4,
                         G=2, d=16, itemsize=4)
    assert c.kernels == {"flash_attention_fwd": [1, f, b]}
    assert c.flops == f and f == 4 * 4 * 16 * (64 * 65 // 2)


def test_the_counter_refuses_what_it_cannot_count():
    with R.count_work():
        with pytest.raises(RuntimeError):
            with R.count_work():
                pass
        with pytest.raises(NotImplementedError):
            torch.nn.functional.conv1d(torch.zeros(1, 2, 8),
                                       torch.zeros(3, 2, 3))
    with pytest.raises(KeyError):
        R.kernel_cost("softmax", n=1)
    assert R.ACTIVE is None


def test_matmul_flops_and_traffic_rules():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with R.count_work() as c:
        y = a @ b                                    # mm
        torch.einsum("bij,bjk->bik", a.view(2, 4, 16), b.expand(2, 16, 4))
        y.t().reshape(-1)                            # a copy, no FLOP
        y.view(-1)                                   # a view: nothing
        torch.zeros(4).copy_(torch.ones(4))          # dst written only
    assert c.flops == 2 * 8 * 16 * 4 + 2 * 2 * 4 * 16 * 4
    assert c.ops["aten.mm"] == [1, 2 * 8 * 16 * 4, (8 * 16 + 16 * 4
                                                    + 8 * 4) * 4]
    assert c.ops["aten.copy_"][2] == 2 * 4 * 4
    assert "aten.view" not in c.ops and "aten.t" not in c.ops
    big = torch.zeros(1, 1024, 1024)
    with R.count_work() as c:
        big.exp()
    assert c.score_bytes == 2 * big.numel() * 4 and c.bytes_traffic == 0


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dry_run_static_bytes_at_full_width():
    """tinyllama-1.1b x train_4k on meta: what the port holds is 16 bytes
    a block parameter (bf16 weight and gradient, fp32 master, mu, nu) and
    18 a shared one (its gradient fp32), the blocks padded to L_pad."""
    res = dryrun.run_cell("tinyllama-1.1b", "train_4k", P=4)
    assert res["status"] == "ok" and res["plan"]["num_microbatches"] == 128
    cfg = get_config("tinyllama-1.1b")
    d, V = cfg.d_model, cfg.vocab_size
    n_shared = 2 * V * d + d
    one = LM(dataclasses.replace(cfg, num_layers=1), device="meta").init(None)
    per_layer = sum(a.numel() for a in tree_leaves(one)) - n_shared
    L_pad = res["plan"]["L_pad"]
    assert L_pad == 24
    st = res["memory"]["static"]
    assert st["params"] == per_layer * L_pad + n_shared
    assert st["total"] == 16 * per_layer * L_pad + 18 * n_shared
    assert st["per_stage"] == 16 * per_layer * L_pad // 4
    r = res["roofline"]
    assert r["model_flops"] == R.model_flops_for(cfg, get_shape("train_4k"),
                                                 "train")
    assert 0 < r["useful_ratio"] < 1 and r["chips"] == 1
    assert res["collectives"]["count_by_kind"]["collective-permute"] == \
        2 * 128 * (2 * 4 - 1)
    assert res["memory"]["fits_80gb"] is True


def test_dry_run_cli_and_summary(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS", str(tmp_path / "dry"))
    for shape in ("decode_32k", "long_500k"):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "tinyllama-1.1b", "--shape", shape])
        assert e.value.code == 0
    cells = S.load(str(tmp_path / "dry"))
    (tag, got), = cells.items()
    assert tag == "onecard_P4"
    assert got[("tinyllama-1.1b", "long_500k")]["status"] == "skipped"
    dec = got[("tinyllama-1.1b", "decode_32k")]
    assert dec["status"] == "ok" and dec["roofline"]["dominant"] == "memory"
    out = S.main(str(tmp_path / "dry"))
    text = open(out).read()
    assert "| tinyllama-1.1b | decode_32k | ok |" in text
    assert "cells: ok=1 skipped=1 error=0" in text
    json.dumps(dec)
