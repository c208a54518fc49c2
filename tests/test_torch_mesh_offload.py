"""Chronos-Offload on a ``pp x dp x tp`` mesh, on the CPU: eight gloo
ranks (2, 2, 2) holding CPU tensors, spawned once
(``tests/helpers/torch_mesh_offload.py`` holds the rank bodies).
Reduced configs (4 layers, d 128, fp32), chronos_zb P=2 v=2 with the
deepest chunk offloaded, m=4, two sequences of 17 tokens a dp rank a
microbatch, the bridged JAX weights of ``tests/test_torch_offload.py``.

The oracle is that file's composed one, at the global batch (four
sequences a microbatch): ``jax.grad`` of the JAX ``LM.loss`` over
``m``; the deep chunk's layers updated by JAX ``HostAdamW`` and rounded
through bf16, as the reference's upload does; every other leaf by JAX
``adamw_update`` over the shallow and shared tree (its own gradient norm
and clip).  The ranks' parts are joined into global trees by where each
lies (``LeafPart``).  Bounds are that file's: losses ``LOSS_TOL``, first
moments ``MU_TOL``, masters ``W_TOL`` for all but ``W_FRAC`` of them.

The quantized shipment (``grad_compression`` int8 / int16) is held
against the reference's quantizer over the *global* deep leaf (one
scale over ``[P, n_off, ...]``, ``jnp.max(jnp.abs(g))``): every rank's
scale is the joined leaf's, bitwise, and its codes too; its host update
at step 1 against the oracle fed the reference's dequantized shipment.
Later steps of a compressed run are not held to the oracle: the shared
gradients' int EF sum on the mesh quantizes each dp rank's partial
(ROADMAP §C), which the reference does not."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core.pipeline_runtime import StageLayout as JaxStageLayout
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.compression import dequantize_int8, quantize_int8
from repro.optim.offload import HostAdamW as JaxHostAdamW
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.configs.base import (OffloadConfig, OptimizerConfig,
                                      ParallelPlan, ShapeConfig, TrainConfig)
from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                               make_pipeline_spec,
                                               unstage_params)
from repro_torch.data import SyntheticLM
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn
from repro_torch.launch.steps import offload_kept
from repro_torch.optim.compression import grid_scale, quantize_with
from repro_torch.optim.offload import merge_deep_shallow
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from helpers import torch_mesh_offload as O
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_offload import (LOSS_TOL, MU_TOL, OCFG, W_FRAC, W_TOL,
                                _deep_rows, _jax_total_loss_fn, _merge_lm,
                                _redraw, _split_lm)

SPAWN_TIMEOUT = 240          # seconds, the one spawn
P, V, M, MBB, SEQ, DP, TP = 2, 2, 4, 2, 17, 2, 2
STEPS = 3
# a code of the quantized shipment may sit at a rounding edge, where the
# two sides' sums (an ulp apart) round to neighbours: one code at most,
# at most this many of them (tests/test_torch_wire.py's bound)
CODES_MOVED = 8


def _np_params(arch):
    """The JAX package's ``init_pipeline_params`` weights (P, V) of the
    reduced ``arch``, redrawn as ``tests/test_torch_offload.py``'s."""
    jcfg = jax_get_reduced(arch)
    params, _ = jax_init_pipeline_params(jax.random.key(0), jcfg,
                                         JaxStageLayout.build(jcfg, P, V))
    return _redraw(jax.tree.map(np.asarray, params), 10)


def _tc(arch="tinyllama-1.1b", zero_stage=1, comp="none"):
    return TrainConfig(
        model=get_reduced(arch),
        shape=ShapeConfig("t", SEQ, M * MBB * DP, "train"),
        plan=ParallelPlan(schedule="chronos_zb", num_chunks=V,
                          microbatch_size=MBB, num_microbatches=M,
                          kernels="fused", zero_stage=zero_stage,
                          grad_compression=comp,
                          offload=OffloadConfig(enabled=True,
                                                num_offload_chunks=1)),
        optimizer=OptimizerConfig(**OCFG), seed=5, log_every=100)


# (arch, zero stage, grad_compression, steps)
RUNS = {"tinyllama-z1": ("tinyllama-1.1b", 1, "none", STEPS),
        "tinyllama-z3": ("tinyllama-1.1b", 3, "none", STEPS),
        "mamba2-z1": ("mamba2-2.7b", 1, "none", STEPS),
        "tinyllama-int8": ("tinyllama-1.1b", 1, "int8_ef", 1)}
# (arch, zero stage, shipment bits)
PROBES = {"int8-z1": ("tinyllama-1.1b", 1, 8),
          "int16-z3": ("tinyllama-1.1b", 3, 16)}


@pytest.fixture(scope="module")
def mesh222():
    params = {a: _np_params(a) for a in ("tinyllama-1.1b", "mamba2-2.7b")}
    runs = [(_tc(a, z, c), params[a], n) for a, z, c, n in RUNS.values()]
    probes = [(_tc(a, z), params[a], b) for a, z, b in PROBES.values()]
    outs = spawn(8, O.offload_suite, args=(runs, probes), shape=(2, 2, 2),
                 device="cpu", timeout_s=SPAWN_TIMEOUT)
    return {"params": params,
            "runs": {k: [o["runs"][i] for o in outs]
                     for i, k in enumerate(RUNS)},
            "probes": {k: [o["probes"][i] for o in outs]
                       for i, k in enumerate(PROBES)}}


_ORACLES = {}


def _oracle(arch, np_params, steps, ship_bits=None):
    """:func:`_run_oracle`, once a case (the cases share weights by
    arch)."""
    key = (arch, steps, ship_bits)
    if key not in _ORACLES:
        _ORACLES[key] = _run_oracle(arch, np_params, steps, ship_bits)
    return _ORACLES[key]


def _run_oracle(arch, np_params, steps, ship_bits=None):
    """The composed JAX oracle over ``steps`` steps at the global batch:
    losses, the device update's gradient norms (the shallow and shared
    leaves'), the full gradients' norms, its state (``mu``, ``master``
    merged from the device and host optimizers, in LM layout), the deep
    rows, and the deep gradients of step 1 (``g / m``, LM layout).  With
    ``ship_bits`` the deep gradients reach the host through the
    reference's quantizer over each whole leaf."""
    cfg = get_reduced(arch)
    spec = make_pipeline_spec(cfg, P=P, v=V, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule="chronos_zb")
    params = lm_params_from_numpy(np_params, "cpu")
    rows = _deep_rows(spec, params)
    jp = jax.tree.map(jnp.asarray, tree_map(
        lambda a: a.numpy().copy(), unstage_params(params, spec.layout)))
    vg = _jax_total_loss_fn(jax_get_reduced(arch))
    jocfg = JaxOptimizerConfig(**OCFG)
    j_sh, j_deep = _split_lm(jp, rows)
    jstate = jax_adamw_init(j_sh)
    host = JaxHostAdamW(jax.tree.map(np.asarray, j_deep), jocfg)
    update = jax.jit(lambda g, s: jax_adamw_update(g, s, jocfg,
                                                   use_kernel=True))
    src = SyntheticLM(cfg.vocab_size, SEQ, seed=5)
    out = {"losses": [], "norms": [], "full_norms": [], "rows": rows}
    for _ in range(steps):
        toks = src.next_batch(M * MBB * DP).reshape(M, MBB * DP, SEQ)
        loss, g = vg(jp, toks)
        out["losses"].append(float(loss) / M)
        g = jax.tree.map(lambda a: a.astype(jnp.float32) / M, g)
        out["full_norms"].append(float(jnp.sqrt(sum(
            jnp.sum(a * a) for a in jax.tree.leaves(g)))))
        g_sh, g_deep = _split_lm(g, rows)
        out.setdefault("g_deep", g_deep)
        m_sh, jstate, om = update(g_sh, jstate)
        out["norms"].append(float(om["grad_norm"]))
        if ship_bits:
            g_deep = jax.tree.map(lambda a: dequantize_int8(
                *quantize_int8(a)), g_deep)
        m_deep = host.update(jax.tree.map(np.asarray, g_deep))
        up = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16)
                          .astype(jnp.float32), m_deep)
        jp = jax.tree.map(jnp.asarray, _merge_lm(m_sh, up, rows))
    for key in ("mu", "master"):
        out[key] = jax.tree.leaves(_merge_lm(jstate[key], getattr(host, key),
                                             rows))
        out["host_" + key] = jax.tree.leaves(getattr(host, key))
    return out


def _joined_state(ranks, arch, key, deep_rows=None):
    """A state tree (``mu`` or ``master``) joined from the ranks: the
    device optimizer's kept leaves and the host optimizer's deep ones,
    merged into the stage-stacked tree, in LM layout (its leaves; with
    ``deep_rows``, those of its deep chunk's layers only)."""
    cfg = get_reduced(arch)
    spec = make_pipeline_spec(cfg, P=P, v=V, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule="chronos_zb")
    meta = init_pipeline_params(None, cfg, spec.layout, "meta")
    kept_t, deep_t = offload_kept(meta, _tc(arch).plan)
    kept = tree_unflatten(kept_t, [torch.from_numpy(a) for a in
                                   O.join(ranks, key)])
    deep = tree_unflatten(deep_t, [torch.from_numpy(a) for a in
                                   O.join(ranks, "host_" + key)])
    full = {**kept, "blocks": merge_deep_shallow(kept["blocks"], deep)}
    lm = unstage_params(full, spec.layout)
    if deep_rows is None:
        return tree_leaves(lm)
    return jax.tree.leaves(_split_lm(tree_map(lambda a: a.numpy(), lm),
                                     deep_rows)[1])


def _diffs(ours, ref):
    return np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel()
                           for a, b in zip(ours, ref)])


@pytest.mark.parametrize("case", [k for k in RUNS if "int8" not in k])
def test_offload_on_the_mesh_matches_composed_jax_oracle(case, mesh222):
    """3 steps of ``train_pipeline(mesh=)`` with the deep chunk offloaded,
    every rank's host holding its deep slices, against the composed
    oracle: losses (equal on every rank), the joined first moments and
    masters (device and host) at ``tests/test_torch_offload.py``'s
    bounds; the dp replicas and tp-replicated leaves bitwise equal after
    every step."""
    arch, _, _, steps = RUNS[case]
    ranks = mesh222["runs"][case]
    ref = _oracle(arch, mesh222["params"][arch], steps)
    losses = ranks[0]["losses"]
    assert all(r["losses"] == losses for r in ranks)
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=LOSS_TOL)
    assert losses[-1] < losses[0]
    assert all(all(c.values()) for r in ranks for c in r["checks"])
    d_mu = _diffs(_joined_state(ranks, arch, "mu"), ref["mu"])
    d_w = _diffs(_joined_state(ranks, arch, "master"), ref["master"])
    frac = float((d_w > W_TOL).mean())
    print(f"{case}: losses {losses} vs {ref['losses']}; max |d| mu "
          f"{d_mu.max():.3e}, master {d_w.max():.3e} ({frac:.2e} beyond "
          f"{W_TOL:g})")
    assert d_mu.max() <= MU_TOL
    assert frac <= W_FRAC and d_w.max() <= 2 * OCFG["lr"] * steps
    assert all(r["offload"]["submits"] == steps for r in ranks)


def test_the_host_holds_only_the_ranks_deep_slices(mesh222):
    """Each rank's host state is its part of the deep leaves: at ZeRO-1
    the dp slices of its tp shards (half of what stage 0 would hold on
    dp 2, none of the shallow chunk or the shared leaves), at ZeRO-3 the
    same slices (the fsdp cut), and the device's deep weights are each
    host master rounded through bf16."""
    for case in ("tinyllama-z1", "tinyllama-z3"):
        ranks = mesh222["runs"][case]
        cfg = get_reduced("tinyllama-1.1b")
        spec = make_pipeline_spec(cfg, P=P, v=V, m=M, microbatch=MBB,
                                  seq_len=SEQ, schedule="chronos_zb")
        deep = offload_kept(init_pipeline_params(None, cfg, spec.layout,
                                                 "meta"), _tc().plan)[1]
        whole = sum(a.numel() for a in tree_leaves(deep))
        for r in ranks:
            held = sum(a.size for _, a in r["host_master"])
            assert held < whole // (P * TP), (case, held, whole)
        # the joined host masters cover every deep element once
        joined = O.join(ranks, "host_master")
        assert sum(a.size for a in joined) == whole
        # device deep weights == host masters through bf16
        params = O.join(ranks, "params")
        meta = init_pipeline_params(None, cfg, spec.layout, "meta")
        w = tree_unflatten(meta, [torch.from_numpy(a) for a in params])
        _, w_deep = offload_kept(w, _tc().plan)
        for a, mst in zip(tree_leaves(w_deep), joined):
            assert torch.equal(a, torch.from_numpy(mst).to(torch.bfloat16)
                               .float())


def test_the_clip_norm_leaves_the_deep_gradients_out(mesh222):
    """The device update's clip norm is the shallow and shared leaves'
    (the reference's ``adamw_update(g_dev)``): every step's gradient norm
    on the ranks equals the oracle's over those leaves within 1e-5
    relative, and at step 1 sits well away from the norm of all the
    gradients."""
    ranks = mesh222["runs"]["tinyllama-z1"]
    ref = _oracle("tinyllama-1.1b", mesh222["params"]["tinyllama-1.1b"],
                  STEPS)
    ours = ranks[0]["grad_norms"]
    assert all(r["grad_norms"] == ours for r in ranks)
    np.testing.assert_allclose(ours, ref["norms"], rtol=1e-5)
    gap = abs(ours[0] - ref["full_norms"][0]) / ref["full_norms"][0]
    print(f"kept norms {ours} (oracle {ref['norms']}); all gradients' "
          f"{ref['full_norms']}: step-1 gap {gap:.3e}")
    assert gap > 1e-3


@pytest.mark.parametrize("probe", list(PROBES))
def test_the_shipment_scale_is_the_global_leafs(probe, mesh222):
    """A quantized shipment's scale is one over the whole global deep
    leaf: every rank's scale of a leaf is the same, equal bitwise to
    ``grid_scale`` of the largest of the ranks' own amaxes -- where a
    rank's own amax differs, so a rank-local scale would be another --
    and to the reference's quantizer over the joined leaf (int8:
    ``quantize_int8``; int16: its ``max(|g|) / 32767``); every rank's
    codes are the joined leaf's codes at its part."""
    arch, _, bits = PROBES[probe]
    ranks = mesh222["probes"][probe]
    n = len(ranks[0]["scales"])
    differ = 0
    for i in range(n):
        scales = [float(r["scales"][i]) for r in ranks]
        assert len(set(scales)) == 1
        amax = max(r["amax"][i] for r in ranks)
        want = float(grid_scale(torch.tensor(amax, dtype=torch.float32),
                                bits))
        assert scales[0] == want
        differ += any(r["amax"][i] != amax for r in ranks)
        joined = O.join([{"g": list(zip(r["parts"], r["g"]))}
                         for r in ranks], "g")[i] / np.float32(ranks[0]["m"])
        if bits == 8:
            codes, s = quantize_int8(jnp.asarray(joined))
        else:
            s = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(joined))),
                            1e-30) / 32767.0
            codes = jnp.clip(jnp.round(jnp.asarray(joined) / s), -32767,
                             32767).astype(jnp.int16)
        assert np.float32(s) == np.float32(scales[0])
        codes = np.asarray(codes)
        for r in ranks:
            assert np.array_equal(r["codes"][i],
                                  codes[r["parts"][i].index])
            assert np.array_equal(r["codes"][i], quantize_with(
                torch.from_numpy(r["g"][i]) / ranks[0]["m"],
                torch.tensor(scales[0]), bits).numpy())
    print(f"{probe}: {n} deep leaves, {differ} with a rank whose own amax "
          f"is below the leaf's")
    assert differ > 0


def test_the_int8_shipment_updates_the_host_as_the_reference(mesh222):
    """Step 1 of the int8_ef offload run: the loss, and the joined host
    state against the oracle whose deep gradients go through the
    reference's ``quantize_int8`` / ``dequantize_int8`` over each whole
    leaf before JAX ``HostAdamW``: first moments at ``MU_TOL`` but where
    a code sits at a rounding edge (one code at most, at most
    ``CODES_MOVED`` of them), masters at ``W_TOL`` for all but
    ``W_FRAC``."""
    ranks = mesh222["runs"]["tinyllama-int8"]
    ref = _oracle("tinyllama-1.1b", mesh222["params"]["tinyllama-1.1b"], 1,
                  ship_bits=8)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert abs(ranks[0]["losses"][0] - ref["losses"][0]) <= LOSS_TOL
    # the deep layers' first moments: (1 - b1) times the dequantized
    # shipment at step 1
    rows = ref["rows"]
    scales = [float(np.asarray(quantize_int8(jnp.asarray(a))[1]))
              for a in jax.tree.leaves(ref["g_deep"])]

    def diffs(key):
        ours = _joined_state(ranks, "tinyllama-1.1b", key, deep_rows=rows)
        assert len(ours) == len(ref["host_" + key])
        return np.concatenate([np.abs(np.asarray(a) - np.asarray(b)).ravel()
                               for a, b in zip(ours, ref["host_" + key])])
    d_mu = diffs("mu")
    big = d_mu[d_mu > MU_TOL]
    step = 0.1 * max(scales)
    print(f"int8 shipment: max |d mu| {d_mu.max():.3e}, {big.size} beyond "
          f"{MU_TOL:g} (one code: {step:.3e})")
    assert big.size <= CODES_MOVED and (big <= step * 1.01).all()
    d_w = diffs("master")
    assert float((d_w > W_TOL).mean()) <= W_FRAC
    assert d_w.max() <= 2 * OCFG["lr"]


def test_offload_bytes_are_collective_stats(mesh222):
    """The bytes each step hands to collectives, over the ranks, by axis:
    ``collective_stats(offload_chunks=1)``, the kept leaves' ZeRO-1
    all-gather within the step and the deep leaves' after the upload
    (counted in the step that shipped them), at stages 1 and 3."""
    for case in ("tinyllama-z1", "tinyllama-z3", "mamba2-z1"):
        arch, z, _, steps = RUNS[case]
        spec = make_pipeline_spec(get_reduced(arch), P=P, v=V, m=M,
                                  microbatch=MBB, seq_len=SEQ,
                                  schedule="chronos_zb", overlap=False)
        cs = dryrun.collective_stats(spec, DP, TP, zero_stage=z,
                                     offload_chunks=1)
        base = dryrun.collective_stats(spec, DP, TP, zero_stage=z)
        ranks = mesh222["runs"][case]
        for step in range(steps):
            got = {a: sum(r["axis_bytes"][step][a] for r in ranks)
                   for a in ("pp", "data", "model")}
            assert got == cs.by_axis, (case, step, got, cs.by_axis)
        if z == 1:
            assert cs.bytes_by_kind["all-gather-deep"] > 0
        # the kept and deep gathers are the whole tree's but for the
        # leaves whose state the whole tree cuts on the chunk axis
        assert cs.by_axis["data"] <= base.by_axis["data"]
        assert cs.by_axis["pp"] == base.by_axis["pp"]
