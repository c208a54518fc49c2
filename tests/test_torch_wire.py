"""The port's compressed pipeline wire, compressed shared-gradient sum and
quantized offload shipment against the JAX package, on the CPU: reduced
tinyllama, mamba2 (tied embeddings) and whisper (an encoder output in
the payload), P=2, v=2, m=4, two sequences of 17 tokens per microbatch.

Bitwise pairs against the reference's own functions: ``compressed_sum``
against ``compressed_psum`` under ``jax.vmap(axis_name=)`` (as
``tests/test_compression.py`` runs it), ``quantize_int8`` /
``dequantize_int8``, the int16 shipment quantizer against a transcription
of the reference's ``ship_deep``, and the port's ring write-then-read
against ``_unpack_payload(_pack_payload(payload))`` for every payload
leaf, wire and compute dtype.

Pipeline pairs: the port's gradients, loss and error feedback with a
compressed wire and/or the compressed shared-gradient sum against the
JAX phase executor's (the only reference executor with ``wire=`` and
``call_ef``) on the same weights and tokens, run in a child process with
two host devices (this file, run as a script, is that child); and
against the port's own fp32 wire at the reference's ``WIRE_PAIRS``
tolerances (``tests/helpers/split_fused_check.py``).  Inputs are made
with numpy from a seed."""
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.pipeline_runtime import _pack_payload, _payload_words
from repro.core.pipeline_runtime import \
    init_pipeline_params as jax_init_pipeline_params
from repro.core.pipeline_runtime import _unpack_payload
from repro.core.pipeline_runtime import \
    make_pipeline_spec as jax_make_pipeline_spec
from repro.optim.compression import compressed_psum
from repro.optim.compression import dequantize_int8 as jax_dequantize_int8
from repro.optim.compression import quantize_int8 as jax_quantize_int8
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.configs.base import (OffloadConfig, OptimizerConfig,
                                      ParallelPlan, ShapeConfig, TrainConfig)
from repro_torch.core import pipeline_runtime as runtime
from repro_torch.core.pipeline_runtime import (_Executor, init_pipeline_params,
                                               init_psum_ef,
                                               make_pipeline_spec,
                                               make_train_grads_fn,
                                               payload_ring_bytes,
                                               psum_writers)
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import (make_pipeline_train_step,
                                      offload_kept, ship_deep)
from repro_torch.launch.train import train_pipeline
from repro_torch.optim import (adamw_init, compressed_sum, dequantize_int8,
                               ef_init, quantize_int8)
from repro_torch.optim.offload import ChronosOffloadRunner
from repro_torch.tree import tree_leaves, tree_map
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

P, V, M, MBB, SEQ = 2, 2, 4, 2, 17
# the reference's pinned wire tolerances (tests/helpers/split_fused_check.py
# WIRE_PAIRS): per leaf max |g_wire - g_fp32| / max |g_fp32|, over the
# measured 5.6e-3 (bf16) and 4.1e-2 (int8) of the reference on this
# config; the port measures 6.7e-3 and 2.9e-2 (chronos, P=2)
WIRE_TOL = {"bf16": 2e-2, "int8": 1e-1}
# the loss of a compressed wire against the fp32 wire's: the boundary
# error moves the mean CE by ~1e-4 here (measured 3.9e-4 int8 at P=2)
WIRE_LOSS_TOL = 2e-3
# train_pipeline with int8_ef (int8 wire) against the uncompressed run,
# 3 steps at lr 1e-3: each step's loss within this gap (measured 4.2e-4,
# 2.7e-3, 9.2e-3: the wire's gradient error moves Adam's normalised
# steps, so the gap grows with the steps taken)
TRAIN_LOSS_GAP = 2e-2
OCFG = dict(warmup_steps=1, total_steps=3, lr=1e-3)
BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}


def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (M, MBB, SEQ)).astype(np.int64))


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / (b.float().abs().max() + 1e-12))


# ---------------------------------------------------------------------------
# compressed_sum, the quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("n", [2, 4])
def test_compressed_sum_matches_jax_compressed_psum(bits, n):
    """Three steps with the error feedback threaded: the reduced sum and
    every stage's residual bitwise the JAX ``compressed_psum``'s (vmap as
    the pipe axis), on a tree of two leaves with different scales."""
    rng = np.random.default_rng(bits + n)
    shapes = {"a": (33, 7), "b": (5,)}
    ef_j = {k: jnp.zeros((n,) + s, jnp.float32) for k, s in shapes.items()}
    ef_t = ef_init({k: torch.zeros((n,) + s) for k, s in shapes.items()})
    for step in range(3):
        g = {k: (rng.standard_normal((n,) + s) * (3.0 if k == "a" else 1e-3))
             .astype(np.float32) for k, s in shapes.items()}
        red_j, ef_j = jax.vmap(
            lambda gi, ei: compressed_psum(gi, "pp", ei, bits=bits),
            axis_name="pp")({k: jnp.asarray(a) for k, a in g.items()}, ef_j)
        parts = [{k: torch.from_numpy(a[i].copy()) for k, a in g.items()}
                 for i in range(n)]
        red_t, ef_t = compressed_sum(parts, ef_t, bits)
        for k in shapes:
            np.testing.assert_array_equal(red_t[k].numpy(),
                                          np.asarray(red_j[k][0]))
            np.testing.assert_array_equal(ef_t[k].numpy(),
                                          np.asarray(ef_j[k]))
        assert float(np.abs(np.asarray(ef_j["a"])).max()) > 0


def test_quantize_int8_matches_jax():
    """Codes, scale and dequantized values bitwise, on rows of mixed
    magnitude, and on an all-zero tensor (the scale's 1e-30 floor)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 65))
         * np.logspace(-3, 2, 65)).astype(np.float32)
    for a in (x, np.zeros((8, 3), np.float32)):
        q_j, s_j = jax_quantize_int8(jnp.asarray(a))
        q_t, s_t = quantize_int8(torch.from_numpy(a))
        assert q_t.dtype == torch.int8
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        assert s_t.numpy() == np.asarray(s_j)
        np.testing.assert_array_equal(dequantize_int8(q_t, s_t).numpy(),
                                      np.asarray(jax_dequantize_int8(q_j,
                                                                     s_j)))


def _jax_ship16(g):
    """``q16`` of the reference's ``ship_deep``
    (``src/repro/launch/steps.py:488-494``), transcribed."""
    g = g.astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(g)), 1e-30) / 32767.0
    return (jnp.clip(jnp.round(g / s), -32767, 32767).astype(jnp.int16), s)


@pytest.mark.parametrize("bits", [8, 16])
def test_ship_deep_matches_the_reference_quantizers(bits):
    """``ship_deep`` over the deep chunk's strided view of a stacked bf16
    leaf (read in slabs): codes and scale bitwise the reference's
    quantizer of ``g.astype(f32) / m`` -- ``quantize_int8``, or the int16
    one of its ``ship_deep``, transcribed."""
    rng = np.random.default_rng(2)
    full = torch.from_numpy((rng.standard_normal((2, 2, 3, 8, 40)) * 1e-2)
                            .astype(np.float32)).to(torch.bfloat16)
    codes, scales = ship_deep([{"w": full[:, 1:]}], torch.tensor(4.0), bits)
    g = jnp.asarray(full[:, 1:].float().numpy()) / 4
    q_j, s_j = (jax_quantize_int8 if bits == 8 else _jax_ship16)(g)
    q_t = codes[0]["w"]
    assert q_t.dtype == (torch.int8 if bits == 8 else torch.int16)
    assert q_t.is_contiguous()
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    assert scales[0]["w"].numpy() == np.asarray(s_j)


# ---------------------------------------------------------------------------
# the wire: storage form and read-back
# ---------------------------------------------------------------------------

def _specs(arch, wire, bf16=False):
    cfg, jcfg = get_reduced(arch), jax_get_reduced(arch)
    if bf16:
        cfg = dataclasses.replace(cfg, **BF16)
        jcfg = dataclasses.replace(jcfg, **BF16)
    kw = dict(P=P, v=V, m=M, microbatch=MBB, seq_len=SEQ, schedule="chronos",
              wire=wire)
    return make_pipeline_spec(cfg, **kw), jax_make_pipeline_spec(jcfg, **kw)


def _payload(spec, seed):
    """numpy payload leaves: rows of different magnitudes (one all zero)
    so the per-row scales differ, and the fp32 aux sum."""
    rng = np.random.default_rng(seed)
    d = spec.cfg.d_model
    shapes = [("x", (MBB, spec.S, d)), ("aux", (1,))]
    if spec.enc_len:
        shapes.append(("enc", (MBB, spec.enc_len, d)))
    out = {}
    for k, s in shapes:
        a = rng.standard_normal(s).astype(np.float32)
        if k != "aux":
            a *= np.array([3.0, 1e-2])[:, None, None][:s[0]]
            a[-1, -1] = 0.0 if k == "x" else a[-1, -1]
        out[k] = a
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-base"])
def test_wire_read_back_matches_jax_unpack_pack(arch, wire, bf16):
    """A payload written to a receive slot (where a send lands) and read
    back, and moved on to the activation ring and read there, equals the
    reference's ``_unpack_payload(_pack_payload(payload))`` bitwise, leaf
    by leaf (``x``, ``aux``, whisper's ``enc``); the stored form is the
    compute dtype for an exact leaf, bf16 on the bf16 wire, int8 codes
    and a per-row fp32 scale on the int8 wire."""
    spec, jspec = _specs(arch, wire, bf16)
    dt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    pay = _payload(spec, 7)
    keys = list(pay)
    ex = _Executor(spec, "cpu")
    ex._put("fq", 1, None, 0, tuple(
        torch.from_numpy(pay[k]).to(torch.float32 if k == "aux" else dt)
        for k in keys))
    ex._move(("fq", 1, None, 0), ("act", 1, 0, 0))
    jpay = {k: jnp.asarray(a).astype(jnp.float32 if k == "aux" else jdt)
            for k, a in pay.items()}
    ref = _unpack_payload(jspec, _pack_payload(jspec, jpay))
    for got in (ex._get("fq", 1, None, 0), ex._get("act", 1, 0, 0)):
        for k, a in zip(keys, got):
            assert a.dtype == (torch.float32 if k == "aux" else dt)
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(ref[k].astype(jnp.float32)))
    for leaf in ex.leaves:
        want = leaf.dtype if leaf.exact else (
            torch.bfloat16 if wire == "bf16" else torch.int8)
        assert leaf.rings["fq"][0].dtype == want
        assert (leaf.scales is not None) == (wire == "int8"
                                             and leaf.key != "aux")
    assert ex.leaves[0].exact == (wire == "fp32" or (wire == "bf16"
                                                      and bf16))


@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-base"])
def test_ring_bytes_match_payload_words(arch, wire):
    """One slot stores the reference's packed row width
    (``_payload_words`` uint16 words a row) over the microbatch's rows,
    less the ``aux`` sum the reference repeats on every row; the rings
    the executor allocates, and :func:`payload_ring_bytes`, are that
    times their slots."""
    spec, jspec = _specs(arch, wire)
    ex = _Executor(spec, "cpu")
    want = _payload_words(jspec) * 2 * MBB - 4 * (MBB - 1)
    tab = spec.table
    slots = tab.P * (tab.fq_depth + tab.bq_depth + sum(
        tab.act_depth.values()) + sum(tab.rmt_depth.values())
        + 2 * sum(tab.wstash_depth.values()))
    allocated = sum(a.numel() * a.element_size()
                    for leaf in ex.leaves
                    for rings in (leaf.rings, leaf.scales) if rings
                    for per_dev in rings.values() for r in per_dev
                    for a in (r.values() if isinstance(r, dict) else [r]))
    assert allocated == slots * want
    assert payload_ring_bytes(spec) == slots * want


def test_fp32_wire_is_the_exact_executor():
    """The default wire: every leaf exact, rings in the compute dtype,
    reads are views of the ring slots (no copy, no cast), no scale
    rings; and at bf16 compute the bf16 wire is the same exact wire, its
    gradients bitwise the fp32 wire's."""
    cfg = get_reduced("tinyllama-1.1b")
    spec = make_pipeline_spec(cfg, P=P, v=V, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule="chronos_zb")
    assert spec.wire == "fp32" and spec.grad_psum_bits is None
    ex = _Executor(spec, "cpu")
    assert all(leaf.exact and leaf.scales is None for leaf in ex.leaves)
    for name, c in (("fq", None), ("act", 0), ("wx", 1)):
        for leaf, a in zip(ex.leaves, ex._get(name, 1, c, 0)):
            ring = leaf.rings[name][1] if c is None else \
                leaf.rings[name][1][c]
            assert a.data_ptr() == ring[0].data_ptr() and a.dtype == \
                ring.dtype
    cfg = dataclasses.replace(cfg, **BF16)
    grads = []
    for wire in ("fp32", "bf16"):
        spec = make_pipeline_spec(cfg, P=P, v=V, m=M, microbatch=MBB,
                                  seq_len=SEQ, schedule="chronos_zb",
                                  wire=wire)
        params = init_pipeline_params(torch.Generator().manual_seed(0), cfg,
                                      spec.layout, "cpu")
        grads.append(make_train_grads_fn(spec, "cpu")(
            params, {"tokens": _tokens(cfg)}))
    assert float(grads[0][1]["loss"]) == float(grads[1][1]["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads[0][0]),
                                                 tree_leaves(grads[1][0])))


# ---------------------------------------------------------------------------
# pipeline pairs: the compressed wire and sum against the fp32 wire
# ---------------------------------------------------------------------------

def _grads(arch, schedule, wire="fp32", bits=None, bf16=False, steps=1,
           n_seq=1, v=V):
    cfg = get_reduced(arch)
    if bf16:
        cfg = dataclasses.replace(cfg, **BF16)
    spec = make_pipeline_spec(cfg, P=P, v=v, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule=schedule, wire=wire,
                              grad_psum_bits=bits, n_seq=n_seq)
    params = init_pipeline_params(torch.Generator().manual_seed(0), cfg,
                                  spec.layout, "cpu")
    batch = {"tokens": _tokens(cfg)}
    if cfg.encdec is not None:
        rng = np.random.default_rng(3)
        batch["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (M, MBB, cfg.encdec.num_frames, cfg.d_model)).astype(np.float32))
    fn = make_train_grads_fn(spec, "cpu")
    if not bits:
        return fn(params, batch)
    ef = init_psum_ef(spec, params)
    for _ in range(steps):
        out = fn(params, batch, ef)
        ef = out[2]
    return out


@pytest.mark.parametrize("wire,bits", [("bf16", None), ("int8", None),
                                       ("int8", 8), ("fp32", 8),
                                       ("bf16", 16)])
@pytest.mark.parametrize("arch,schedule", [("tinyllama-1.1b", "chronos"),
                                           ("tinyllama-1.1b", "chronos_zb"),
                                           ("whisper-base", "chronos")])
def test_compressed_pipeline_grads_track_the_fp32_wire(arch, schedule, wire,
                                                       bits):
    """Every gradient leaf (block and shared; whisper's encoder too) of
    the compressed wire and/or the compressed shared-gradient sum within
    the reference's ``WIRE_PAIRS`` tolerance of the fp32 wire's (the
    int8 one for the compressed sum alone), and the loss within
    ``WIRE_LOSS_TOL``."""
    g0, m0 = _grads(arch, schedule)
    out = _grads(arch, schedule, wire, bits)
    tol = WIRE_TOL["int8" if wire == "fp32" else wire]
    errs = [_rel(a, b) for a, b in zip(tree_leaves(out[0]),
                                       tree_leaves(g0))]
    print(f"{arch} {schedule} wire {wire} bits {bits}: max normalized "
          f"|d grad| {max(errs):.3e}, |d loss| "
          f"{abs(float(out[1]['loss']) - float(m0['loss'])):.2e}")
    assert len(errs) == len(tree_leaves(g0)) and max(errs) <= tol
    assert abs(float(out[1]["loss"]) - float(m0["loss"])) <= WIRE_LOSS_TOL
    if bits:
        assert all(float(e.abs().max()) <= float(s) / 2 + 1e-6
                   for e, s in zip(tree_leaves(out[2]),
                                   tree_leaves(out[1]["psum_scale"])))


# (wire, grad_psum_bits) of the pairs against the JAX phase executor,
# reduced tinyllama, chronos P=2 v=2 m=4; with bits, EF_STEPS steps of the
# same batch with the error feedback threaded
JAX_CASES = [("fp32", None), ("bf16", None), ("int8", None), ("fp32", 8),
             ("int8", 8)]
EF_STEPS = 3
# Per gradient leaf max |d| / max |jax|, port against the JAX executor.
# Measured: fp32 wire 1.26e-6 (summation order alone), int8 wire 8.3e-7
# (no code moves: the quantizer sees the same boundary to an ulp, far
# from a rounding edge at this size), bf16 wire 2.14e-3 (an ulp of fp32
# difference at a bf16 rounding edge moves that element one bf16 step,
# 2^-8 of it).  A wire that stored nothing compressed sits 6.7e-3
# (bf16) and 2.9e-2 (int8) from these, one compressed at another
# boundary further still.
JAX_GRAD_TOL = {("fp32", None): 5e-6, ("bf16", None): 4e-3,
                ("int8", None): 5e-6, ("fp32", 8): 5e-6, ("int8", 8): 5e-6}
# |d loss|: measured 0 (fp32), 4.8e-7 (int8, one ulp of the loss),
# 1.34e-5 (bf16)
JAX_LOSS_TOL = {("fp32", None): 1e-5, ("bf16", None): 5e-5,
                ("int8", None): 1e-5, ("fp32", 8): 1e-5, ("int8", 8): 1e-5}
# Through the compressed sum, the shared gradients and the error
# feedback, element by element in codes of the leaf's shared scale.  The
# two sides' sums differ by an ulp or so of fp32, far below CODE_NOISE;
# where a partial sits at a rounding edge the element moves one code in
# the sum and in that stage's residual (one a writer, two at most here:
# JAX_CODE_TOL), and JAX_CODES_MOVED bounds how many do: measured 2 of
# 262,400 (fp32 wire: one partial at an edge, its sum's element and its
# residual's) and 0 (int8 wire).  A residual that is not threaded moves
# ~94,500 of them.
CODE_NOISE = 1e-3
JAX_CODE_TOL = 2
JAX_CODES_MOVED = {("fp32", 8): 8, ("int8", 8): 8}


def _jax_pair_setup(wire, bits):
    """(port spec, JAX spec, JAX params, port params, tokens): the reduced
    tinyllama at ``wire`` / ``bits``, the weights the JAX
    ``init_pipeline_params`` bits, the tokens from a numpy seed."""
    kw = dict(P=P, v=V, m=M, microbatch=MBB, seq_len=SEQ, schedule="chronos",
              wire=wire, grad_psum_bits=bits)
    jspec = jax_make_pipeline_spec(jax_get_reduced("tinyllama-1.1b"),
                                   kernels="xla", **kw)
    jparams, _ = jax_init_pipeline_params(jax.random.key(0), jspec.cfg,
                                          jspec.layout)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(1).integers(
        0, jspec.cfg.vocab_size, (M, MBB, SEQ)).astype(np.int32)
    spec = make_pipeline_spec(get_reduced("tinyllama-1.1b"), kernels="plain",
                              **kw)
    return spec, jspec, jparams, params, tokens


def _case(wire, bits):
    return f"{wire}-{bits}"


@pytest.fixture(scope="module")
def jax_wire_grads(tmp_path_factory):
    """The JAX phase executor's gradients, loss and error feedback for
    every case of ``JAX_CASES``, from one child process with two host
    devices."""
    out = tmp_path_factory.mktemp("wire") / "jax_wire.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, __file__, str(out)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("wire,bits", JAX_CASES,
                         ids=[_case(*c) for c in JAX_CASES])
def test_pipeline_wire_matches_jax_phase_executor(wire, bits,
                                                  jax_wire_grads):
    """The port's gradients and loss with a compressed wire and/or the
    compressed shared-gradient sum against the JAX phase executor with
    the same ``wire`` / ``grad_psum_bits``, same weights and tokens; with
    the sum, after ``EF_STEPS`` steps with the error feedback threaded,
    the error feedback too: the rows of the stages that write a shared
    leaf against the port's (:func:`psum_writers`), every other row of
    the reference's ``[P, ...]`` stack zero.  The fp32 wire ties the
    harness to the port's executor, which ``tests/test_torch_train.py``
    holds to ``jax.grad``."""
    spec, jspec, jparams, params, tokens = _jax_pair_setup(wire, bits)
    fn = make_train_grads_fn(spec, "cpu")
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64))}
    if bits:
        ef = init_psum_ef(spec, params)
        for _ in range(EF_STEPS):
            grads, met, ef = fn(params, batch, ef)
    else:
        grads, met = fn(params, batch)
    ref = {k[len(_case(wire, bits)) + 1:]: a for k, a in
           jax_wire_grads.items() if k.startswith(_case(wire, bits) + "/")}
    shared_keys = [k for k in sorted(grads) if k != "blocks"]
    ours = tree_leaves(grads["blocks"]) + [
        g for k in shared_keys for g in tree_leaves(grads[k])]
    n_blk = len(tree_leaves(grads["blocks"]))
    errs = []
    for i, g in enumerate(ours):
        want = ref[f"g{i}"]
        assert want.shape == tuple(g.shape)
        errs.append(float(np.abs(g.float().numpy() - want).max()
                          / (np.abs(want).max() + 1e-12)))
    e_loss = abs(float(met["loss"]) - float(ref["loss"]))
    msg = (f"wire {wire} bits {bits}: per-leaf max|d| / max|jax| blocks "
           f"{max(errs[:n_blk]):.3e} shared {max(errs[n_blk:]):.3e}; "
           f"|d loss| {e_loss:.3e}")
    if bits:
        scales = tree_leaves(met["psum_scale"])
        writers = psum_writers(spec, {k: params[k] for k in shared_keys})
        # |d| in codes of each leaf's shared scale, element by element
        codes = [np.abs(g.numpy() - ref[f"g{n_blk + j}"]).ravel() / float(s)
                 for j, (g, s) in enumerate(zip(ours[n_blk:], scales))]
        for j, (e, w, s) in enumerate(zip(tree_leaves(ef), writers, scales)):
            want = ref[f"ef{j}"]
            assert want.shape == (P,) + tuple(e.shape[1:])
            for d in range(P):
                if d in w:
                    codes.append(np.abs(e[w.index(d)].numpy()
                                        - want[d]).ravel() / float(s))
                else:
                    assert not want[d].any()
        codes = np.concatenate(codes)
        moved = int((codes > CODE_NOISE).sum())
        msg += (f"; shared gradients and EF: max|d| {codes.max():.3f} "
                f"codes, {moved} of {codes.size} elements past "
                f"{CODE_NOISE} codes")
    print(msg)
    assert max(errs[:n_blk]) <= JAX_GRAD_TOL[wire, bits]
    assert e_loss <= JAX_LOSS_TOL[wire, bits]
    if bits:
        assert codes.max() <= JAX_CODE_TOL
        assert moved <= JAX_CODES_MOVED[wire, bits]
    else:
        assert max(errs[n_blk:]) <= JAX_GRAD_TOL[wire, bits]


def _jax_wire_child(out):
    """Run as a script: the JAX phase executor's gradients (block leaves,
    then the shared ones) and loss for every case of ``JAX_CASES``, and
    with ``grad_psum_bits`` its error feedback after ``EF_STEPS`` steps,
    as fp32 arrays in ``out``.

    JAX 0.9's ``shard_map`` tracks varying manual axes.  The reference's
    phase executor, written for the pinned 0.4.x that tracks none, joins
    a varying branch with an invariant one (a zero) in its loss-head
    ``lax.cond`` and its op ``lax.switch``, which 0.9 refuses at trace
    time.  Here, and only when the branches disagree, each branch's
    outputs are ``pcast`` to varying, the repair the refusal itself
    names; it changes no value.  The fp32 case checks that: it must equal
    the port's executor, which is held to ``jax.grad``."""
    from repro import jax_compat
    from repro.core.pipeline_runtime import \
        init_psum_ef as jax_init_psum_ef
    from repro.core.pipeline_runtime import \
        make_train_grads_fn as jax_make_train_grads_fn
    from repro.models import shard_env

    def varying(fn):
        return lambda *a: jax.tree.map(
            lambda x: jax_compat.to_varying(x, "pp"), fn(*a))

    def retry_varying(op, wrap):
        def call(index, *branches_and_ops, **kw):
            try:
                return op(index, *branches_and_ops, **kw)
            except TypeError as e:
                if "varying manual axes" not in str(e):
                    raise
            return op(index, *wrap(branches_and_ops), **kw)
        return call

    jax.lax.cond = retry_varying(
        jax.lax.cond, lambda a: (varying(a[0]), varying(a[1])) + a[2:])
    jax.lax.switch = retry_varying(
        jax.lax.switch, lambda a: ([varying(b) for b in a[0]],) + a[1:])
    mesh = jax_compat.make_mesh((P,), ("pp",))
    res = {}
    for wire, bits in JAX_CASES:
        _, jspec, jparams, _, tokens = _jax_pair_setup(wire, bits)
        fn = jax.jit(jax_make_train_grads_fn(jspec, mesh, executor="phase"))
        batch = {"tokens": jnp.asarray(tokens)}
        with shard_env(mesh, {}):
            if bits:
                ef = jax_init_psum_ef(jspec, jparams)
                for _ in range(EF_STEPS):
                    g, met, ef = fn(jparams, batch, ef)
                for j, a in enumerate(jax.tree.leaves(ef)):
                    res[f"{_case(wire, bits)}/ef{j}"] = np.asarray(a)
            else:
                g, met = fn(jparams, batch)
        leaves = jax.tree.leaves(g["blocks"]) + [
            a for k in sorted(g) if k != "blocks"
            for a in jax.tree.leaves(g[k])]
        for i, a in enumerate(leaves):
            res[f"{_case(wire, bits)}/g{i}"] = np.asarray(a).astype(
                np.float32)
        res[f"{_case(wire, bits)}/loss"] = np.float32(met["loss"])
    np.savez(out, **res)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_seq_executor_wire_tracks_its_fp32_wire(wire):
    """chronos_seq, two sequence chunks: the ``Sc``-position payloads in
    the wire's form, the KV-carry and dKV rings exact."""
    g0, m0 = _grads("tinyllama-1.1b", "chronos_seq", n_seq=2)
    g1, m1 = _grads("tinyllama-1.1b", "chronos_seq", wire, n_seq=2)
    errs = [_rel(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g0))]
    print(f"chronos_seq wire {wire}: max normalized |d grad| "
          f"{max(errs):.3e}")
    assert max(errs) <= WIRE_TOL[wire]
    assert abs(float(m1["loss"]) - float(m0["loss"])) <= WIRE_LOSS_TOL
    assert max(errs) > 0


@pytest.mark.parametrize("arch,schedule", [("tinyllama-1.1b", "chronos"),
                                           ("tinyllama-1.1b", "v_min"),
                                           ("mamba2-2.7b", "chronos_zb"),
                                           ("whisper-base", "chronos")])
def test_psum_partials_where_written_equal_the_full_construction(
        monkeypatch, arch, schedule):
    """Partials and error feedback only for the stages that write each
    shared leaf (:func:`psum_writers`) against the reference's full
    ``[P, ...]`` construction (every stage a partial, zeros where it
    writes nothing), 3 steps with the EF threaded: gradients, scales and
    every residual row bitwise, the rows of stages that write nothing
    zero throughout.  mamba2 ties its embeddings (two writers of
    ``embed.tokens``); v_min folds the last block back to device 0."""
    a = _grads(arch, schedule, "int8", 8, steps=3)
    cfg = get_reduced(arch)
    spec = make_pipeline_spec(cfg, P=P, v=V, m=M, microbatch=MBB,
                              seq_len=SEQ, schedule=schedule)
    shared = {k: v for k, v in init_pipeline_params(
        torch.Generator().manual_seed(0), cfg, spec.layout, "cpu").items()
        if k != "blocks"}
    writers = psum_writers(spec, shared)
    assert any(len(w) < P for w in writers)
    if arch == "mamba2-2.7b":
        assert (0, 1) in writers
    monkeypatch.setattr(runtime, "psum_writers",
                        lambda spec, shared: [tuple(range(P))] * len(
                            tree_leaves(shared)))
    b = _grads(arch, schedule, "int8", 8, steps=3)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[0]),
                                                 tree_leaves(b[0])))
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a[1]["psum_scale"]), tree_leaves(b[1]["psum_scale"])))
    for w, ea, eb in zip(writers, tree_leaves(a[2]), tree_leaves(b[2])):
        assert eb.shape[0] == P and ea.shape[0] == len(w)
        for d in range(P):
            if d in w:
                assert torch.equal(eb[d], ea[w.index(d)])
            else:
                assert not bool(eb[d].any())


# ---------------------------------------------------------------------------
# train_pipeline: the error feedback threaded, offload, restore, refusals
# ---------------------------------------------------------------------------

def _tc(**plan):
    return TrainConfig(
        model=get_reduced("tinyllama-1.1b"),
        shape=ShapeConfig("t", SEQ, M * MBB, "train"),
        plan=ParallelPlan(**{**dict(schedule="chronos_zb", num_chunks=V,
                                    microbatch_size=MBB,
                                    num_microbatches=M, kernels="fused"),
                             **plan}),
        optimizer=OptimizerConfig(**OCFG), seed=0, log_every=1)


def _record_ef(monkeypatch):
    """Wrap the train step: record ``max |ef|`` of the error feedback
    each step is handed, and of the one it returns."""
    seen = []
    make = train_mod.make_pipeline_train_step

    def wrapped(*a, **kw):
        step, m, mbB, spec = make(*a, **kw)

        def amax(tree):
            return max(float(e.abs().max()) for e in tree_leaves(tree))

        def rec(params, opt_state, batch, ef=None):
            handed = None if ef is None else amax(ef)   # updated in place
            out = step(params, opt_state, batch, ef)
            if ef is not None:
                seen.append((handed, amax(out.ef)))
            return out
        return rec, m, mbB, spec
    monkeypatch.setattr(train_mod, "make_pipeline_train_step", wrapped)
    return seen


def test_train_pipeline_int8_ef_threads_the_error_feedback(monkeypatch):
    """3 steps with int8_ef over the int8 wire: the EF a step is handed is
    the one the step before returned (zero at the first), every residual
    within half its leaf's grid step, the rings a quarter of the fp32
    wire's plus the scales, and each loss within ``TRAIN_LOSS_GAP`` of
    the uncompressed run's."""
    base = train_pipeline(_tc(), P=P, device="cpu", steps=3,
                          log=lambda s: None)
    seen = _record_ef(monkeypatch)
    out = train_pipeline(_tc(wire="int8", grad_compression="int8_ef"), P=P,
                         device="cpu", steps=3, log=lambda s: None)
    assert len(seen) == 3 and seen[0][0] == 0.0
    assert all(seen[i][0] == seen[i - 1][1] > 0 for i in (1, 2))
    w = out["wire"]
    assert w["wire"] == "int8" and set(w["ef_abs_max"]) == \
        {"embed/head", "embed/tokens", "final_norm/scale"}
    for k, e in w["ef_abs_max"].items():
        assert 0 < e <= w["psum_scale"][k] / 2 + 1e-6, k
    assert base["wire"]["ring_bytes"] > 3.9 * w["ring_bytes"]
    gaps = [abs(a - b) for a, b in zip(out["losses"], base["losses"])]
    print(f"int8_ef + int8 wire - uncompressed losses: {gaps}")
    assert max(gaps) <= TRAIN_LOSS_GAP and out["losses"][0] != \
        base["losses"][0]


def test_restore_starts_a_fresh_error_feedback(monkeypatch, tmp_path):
    """The EF is never checkpointed: a run restored from a checkpoint
    hands its first step a zero EF, where the uninterrupted run's step
    at that point gets the previous step's."""
    seen = _record_ef(monkeypatch)
    tc = dataclasses.replace(_tc(grad_compression="int8_ef"),
                             checkpoint_dir=str(tmp_path / "a"),
                             checkpoint_every=1)
    train_pipeline(tc, P=P, device="cpu", steps=2, log=lambda s: None)
    assert seen[1][0] > 0
    seen.clear()
    res = train_pipeline(tc, P=P, device="cpu", steps=3, log=lambda s: None)
    assert res["start_step"] == 2 and len(seen) == 1
    assert seen[0][0] == 0.0 and seen[0][1] > 0
    shutil.rmtree(tmp_path / "a")


@pytest.mark.parametrize("gc,bits", [("int8_ef", 8), ("int16_ef", 16)])
def test_offload_shipment_dequantized_on_the_host(gc, bits):
    """One offload step with a compressed shipment: the codes and scales
    bitwise the reference's ``ship_deep`` (``g.astype(f32) / m``, then
    its quantizer, in JAX) of the same deep gradients, a shipment of
    ``bits / 32`` of the fp32 bytes plus the scales, and the host
    update that dequantizes in its slab workers bitwise the update fed
    the shipment dequantized on the device, as the reference's driver
    does."""
    plan = _tc(grad_compression=gc, offload=OffloadConfig(
        enabled=True, num_offload_chunks=1)).plan
    cfg = get_reduced("tinyllama-1.1b")
    ocfg = OptimizerConfig(**OCFG)
    step, m, _, spec = make_pipeline_train_step(
        cfg, ShapeConfig("t", SEQ, M * MBB, "train"), plan, ocfg, P=P,
        device="cpu")
    params = init_pipeline_params(torch.Generator().manual_seed(0), cfg,
                                  spec.layout, "cpu")
    kept, deep = offload_kept(params, plan)
    deep0 = tree_map(torch.clone, deep)
    # the raw deep gradient sums, from the same step without compression
    # (the compressed shared sum changes no block gradient)
    raw_step, _, _, _ = make_pipeline_train_step(
        cfg, ShapeConfig("t", SEQ, M * MBB, "train"),
        dataclasses.replace(plan, grad_compression="none"), ocfg, P=P,
        device="cpu")
    p_raw = tree_map(torch.clone, params)
    held = raw_step(p_raw, adamw_init(offload_kept(p_raw, plan)[0]),
                    {"tokens": _tokens(cfg)}).shipment
    out = step(params, adamw_init(kept), {"tokens": _tokens(cfg)},
               init_psum_ef(spec, params))
    codes, scales = out.shipment
    quant = jax_quantize_int8 if bits == 8 else _jax_ship16
    for g, q, s in zip(tree_leaves(held), tree_leaves(codes),
                       tree_leaves(scales)):
        q_j, s_j = quant(jnp.asarray(g.numpy()).astype(jnp.float32) / m)
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
        assert s.numpy() == np.asarray(s_j)
    host = ChronosOffloadRunner(tree_map(torch.clone, deep0), ocfg,
                                ship_bits=bits)
    dev = ChronosOffloadRunner(tree_map(torch.clone, deep0), ocfg)
    try:
        n = sum(a.numel() for a in tree_leaves(deep0))
        assert host.bytes_down == n * bits // 8 + 4 * len(tree_leaves(deep0))
        host.submit(codes, scales=scales)
        dev.submit(tree_map(dequantize_int8, codes, scales))
        a, b = host.collect(), dev.collect()
        for x, y in zip(tree_leaves(host.opt.master),
                        tree_leaves(dev.opt.master)):
            np.testing.assert_array_equal(x, y)
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
    finally:
        host.close()
        dev.close()


def test_train_pipeline_offload_with_compression_runs():
    """train_pipeline under offload with int16_ef over the bf16 wire: the
    shipment's bytes are the codes plus scales, losses finite and close
    to the uncompressed offload run's."""
    off = OffloadConfig(enabled=True, num_offload_chunks=1)
    base = train_pipeline(_tc(offload=off), P=P, device="cpu", steps=3,
                          log=lambda s: None)
    out = train_pipeline(_tc(offload=off, wire="bf16",
                             grad_compression="int16_ef"), P=P,
                         device="cpu", steps=3, log=lambda s: None)
    n_leaves = len(tree_leaves(out["host_optimizer"].master))
    assert out["offload"]["bytes_down"] == \
        base["offload"]["bytes_down"] // 2 + 4 * n_leaves   # fp32 -> int16
    assert out["offload"]["submits"] == 3
    assert max(abs(a - b) for a, b in zip(out["losses"], base["losses"])) \
        <= TRAIN_LOSS_GAP


def test_refusals():
    """The reference's refusals, as ValueError: an unknown wire, an
    unknown grad_compression, compression with sequence chunks (at the
    step and at the grads fn), and a compressed sum without its EF."""
    cfg = get_reduced("tinyllama-1.1b")
    kw = dict(P=P, v=V, m=M, microbatch=MBB, seq_len=SEQ,
              schedule="chronos")
    with pytest.raises(ValueError, match="unknown wire"):
        make_pipeline_spec(cfg, wire="fp8", **kw)
    with pytest.raises(ValueError, match="unknown wire"):
        train_pipeline(_tc(wire="int4"), P=P, device="cpu", steps=1,
                       log=lambda s: None)
    with pytest.raises(ValueError, match="grad_compression"):
        train_pipeline(_tc(grad_compression="int4_ef"), P=P, device="cpu",
                       steps=1, log=lambda s: None)
    with pytest.raises(ValueError, match="seq-chunked"):
        train_pipeline(_tc(schedule="chronos_seq", seq_chunks=2,
                           grad_compression="int8_ef"), P=P, device="cpu",
                       steps=1, log=lambda s: None)
    seq = make_pipeline_spec(cfg, **{**kw, "schedule": "chronos_seq"},
                             n_seq=2, grad_psum_bits=8)
    with pytest.raises(ValueError, match="sequence-chunked"):
        make_train_grads_fn(seq, "cpu")
    spec = make_pipeline_spec(cfg, grad_psum_bits=8, **kw)
    params = init_pipeline_params(torch.Generator().manual_seed(0), cfg,
                                  spec.layout, "cpu")
    with pytest.raises(ValueError, match="error-feedback"):
        make_train_grads_fn(spec, "cpu")(params, {"tokens": _tokens(cfg)})


if __name__ == "__main__":
    _jax_wire_child(sys.argv[1])
