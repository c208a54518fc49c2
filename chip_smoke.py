#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card: the ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` compiles ``src/repro_torch/csrc`` for sm_90a;
3. each kernel against its plain PyTorch version on the card, at the
   serving shapes, in bf16 and fp32 (flash also at head dims 16, 32 and
   128, B=2, H == G, 2047 keys and rows that see no key, with each bf16
   case's CTA printed and both CTA sizes run at every head dim, and at
   qwen2-moe's 16 heads of 128: a 64-row serving chunk at offsets 192
   and 448 over 512 slots, and 2048 rows at the training length; rmsnorm
   also at d=100), and timed beside the plain version, a one-call PyTorch
   yardstick and the card's bound (device time per call from CUDA-graph
   replay, rmsnorm over rotating inputs larger than the L2 and, as a
   second reading, on one L2-resident input; the eager call-to-call time
   beside it);
4. serve: full-width tinyllama-1.1b (bf16, random weights from seed 0)
   through ``repro_torch.launch.serve.main``: 8 requests, 4 slots,
   64-token chunks; checks every request and the kernels' launch counts;
   a warm re-run on the same engine gives the numbers without start-up
   costs, and a profiled one says where the device time goes;
5. checks: P=2 virtual stages give P=1's token streams, and the fused and
   plain backends agree on fp32 logits (2 layers, full width);
5a. serve-mamba2: full-width mamba2-2.7b through the same ``main``, 128-
   token chunks (its SSD chunk), 8 requests of 128 or 256 prompt tokens
   and 16-32 new ones: every prefill scan runs the SSD kernel from the
   slot's carried fp32 state (launches 64 x the prefill chunks, no call
   of the plain ``ssd_chunked_ref``), gated as phase 4, profiled as
   phase 4's re-run, with phase 5's checks at 128-token chunks;
5b. serve-qwen2-moe: full-width qwen2-moe-a2.7b (60 routed experts top
   4 plus 4 shared, MHA 16 x 128) with phase 4's traffic and gates, the
   decode tick's weight-read bound beside its per-token time, and phase
   5's checks;
6. train: full-width tinyllama-1.1b (bf16, fp32 optimizer state, random
   weights from seed 0) through ``repro_torch.launch.train.
   train_pipeline``: chronos_zb, P=4 virtual stages, v=2, 8 microbatches
   of one 2049-token sequence, fused kernels and the fused-AdamW update,
   4 steps; checks losses, gradient norms, changed weights and every
   kernel's launch count derived from the task table, then profiles one
   more step;
7. train checks (fp32, full width, 4 layers): pipeline gradients against
   ``LM.loss`` autograd, chronos_recomp == chronos bitwise, fused vs
   plain backend, kernel vs plain AdamW update bitwise;
8. train mamba2-2.7b at full width, cut to 16 of its 64 layers, as
   phase 6 does tinyllama (the SSD scan, rmsnorm and fused-AdamW
   kernels), after freeing tinyllama's tensors, then a profiled step;
9. phase 7's checks on mamba2-2.7b (4 layers, two SSD chunks);
10. train-single: full-width tinyllama-1.1b through ``repro_torch.launch.
    train.train`` (8 sequences of 2049 tokens in 2 microbatches, 4 steps)
    with the recompute modes none, chronos and full, a profiled chronos
    step, then mamba2-2.7b in chronos (8 microbatches of one sequence);
    checks the launch counts derived from the model and the remat, the
    bitwise step-1 losses across modes, their gradient norms, the peak
    memory order none > chronos > full, and in fp32 (4 layers) every
    mode's loss and gradients bitwise against no remat;
11. train-offload: phase 6's and phase 8's runs again with
    ``OffloadConfig(enabled=True, num_offload_chunks=1)`` (the deep
    chunk's fp32 master, mu and nu on the host, its AdamW in numpy there,
    gradients down and bf16 weights up through pinned buffers on a side
    stream); checks losses, gradient norms, moved shallow masters, each
    collect's deep weights against their host masters rounded to bf16,
    the step-1 loss bitwise against the on-device run, the launch counts
    (fused AdamW on the shallow and shared leaves only) and the peak's
    fall of at least 0.9 x the deep state; prints step time, tokens/s,
    ``collect_wait_s``, host update seconds, the copies' GB/s and the
    Eq. (5)/(7) report; then fp32, 4 layers, 3 steps with the gradient
    clip off: offload against the on-device optimizer (|d loss| <= 5e-3)
    and against the on-device optimizer with its deep weights rounded
    to bf16 after every step (<= 1e-4); with the clip on, printed only;
12. train-vshape: phase 6's run with ``v_min`` (the V-shape fold-back:
    device d holds blocks d and 7-d; split backward, fused AdamW);
13. train-seq-chronos: phase 6's run, cut to 8 layers, with
    ``chronos_seq``, n_seq=2 (two 1024-position chunks per sequence,
    KV-carry and dKV rings) and ``RecomputeConfig("chronos",
    num_recomp_chunks=1)``;
14. train-seq-1f1b: phase 6's run, cut to 8 layers, with ``seq1f1b``,
    v=1, n_seq=4;
    phases 12-14 check what phase 6 checks (launch counts from the
    table: a sequence-chunked op runs each layer's flash at its chunk's
    offset) and print step time, tokens/s, peak memory and the table's
    ring depths beside phase 6's, and each profiles one step;
15. fp32, full width, 4 layers: v_min, v_half and v_zb against
    ``LM.loss`` autograd, v_min against the interleaved chronos on the
    same network, chronos_seq (n_seq=2) against chronos and seq1f1b
    (n_seq=4) against 1f1b, with and without a loss mask, each within
    2e-5 relative;
15a. train-qwen2-moe: full-width qwen2-moe-a2.7b cut to 4 layers,
    chronos_zb on P=2 virtual stages (v=2), 8 microbatches of one
    2049-token sequence, the MoE aux sum carried in the payload; gated
    as phase 6, then every MoE layer's lb_loss and dropped fraction under
    the trained weights;
15b. MoE checks, fp32, full width: one layer's ``moe_ffn`` (T=2048,
    skewed routing that drops tokens) against an independent plain MoE
    FFN, outputs, lb_loss, dropped fraction and gradients; pipeline
    loss and gradients (4 layers, P=2, v=2, capacity factor 0.5 so that
    every layer drops) against ``LM.loss`` autograd, chronos_zb and
    chronos, within 2e-5 relative;
16. train-planner: the memory-budget planner (``repro_torch.plan``) on
    the card, each stage's budget a quarter of the card's memory: (a) its
    pick for tinyllama-1.1b trained 4 steps as phase 6; (b) deepseek-7b's
    width: ``max_trainable_layers`` of ``1f1b`` and of the best point,
    then the pick at that depth trained 2 steps (``ep.m`` sequences of
    2049 tokens), both gated as phase 6 (finite losses, moved masters,
    launch counts from the table); (c) for every pipeline training run
    of phases 6-16 (15a included) the planner's per-stage total, the
    one-card prediction with its terms and the measured peak (printed,
    not gated);
17. serve-gemma3: full-width gemma3-27b (62 layers, 52 of them with a
    1024-token sliding window; 27.0 B parameters, 54.0 GB bf16) through
    ``launch.serve.main``: P=1, 4 slots, 128-token chunks, prompts of 1
    to 12 chunks (at least two past the window), 16-32 new tokens,
    gated as phase 4; the peak beside its reckoning (the copying pack
    frees each LM leaf as it packs it: weights plus one block leaf), the
    decode tick's bound, a warm profiled re-run; 17a. reduced gemma3 in
    fp32: the engine's streams and logits at P=2 equal P=1's, and at
    full width (6 layers, fp32) fused vs plain logits past the window;
18. train-paligemma: full-width paligemma-3b (head dim 256, a 256-patch
    prefix of fp32 embeddings from the seed) through ``train_pipeline``,
    chronos_zb P=3 v=2, 8 microbatches of 256 patches + 2048 tokens, 4
    steps and a profiled one, gated as phase 6 (every flash launch on
    the head-dim-256 kernel), the peak beside ``predicted_card_peak``;
    then single-host ``prefill(patch_embeds=)`` and 8 greedy decode
    steps (flash launches: one a layer in prefill, none in decode);
19. train-whisper: full-width whisper-base (6 encoder and 6 decoder
    layers, 1500 fp32 frame embeddings) likewise, 449-token sequences,
    the encoder on the first chunk's ops (its launches in the table's
    count); then ``prefill(frame_embeds=)`` and greedy decode over the
    cached cross K/V (no encoder launch in decode);
20. fp32 pipeline loss and gradients against ``LM.loss`` autograd
    within 2e-5: gemma3 at full width, 6 layers, window 256 under 512
    positions; paligemma at head dim 256 (d 512, 4 heads) with its
    patches; whisper-base at full width, the encoder's gradients in;
21. train-elastic: the elastic drill (``repro_torch.ft.elastic_pipeline.
    train_elastic``): full-width tinyllama-1.1b cut to 8 layers (a save
    is 14 B a parameter: 6.8 GB at P=4, 9.2 GB at P=3, where L_pad rises
    from 8 to 12), chronos_zb v=2, 4 microbatches of one sequence, 6
    steps, a checkpoint every 2 steps in a temporary directory (its free
    bytes printed first, at least 3 saves needed), on P=4 virtual stages
    with a checkpoint-writer death before its rename at step 2, stage
    slot 1 lost at step 3 and back at step 5; against ``train_pipeline``
    at P=4 without checkpoints: P [4, 3, 4], the recoveries
    ``device_loss:4->3`` and ``scale_up:3->4`` with restore and remap,
    every step's loss within 1e-4 of the baseline, the LATEST checkpoint
    bitwise the returned state, launches from the tables of the steps
    each incarnation ran; prints each save's and restore's GB, seconds
    and GB/s, the recovery records, the step time at P=4 and P=3 and the
    peak;
22. train-resume: ``train()`` at full width, 2 layers, recompute chronos:
    5 steps, against 3 steps with a checkpoint every step and a second
    call that restores and runs steps 3-4 (losses and fp32 masters,
    expected bitwise), launch counts;
23. a JSON ``kernels`` line, then the JSON result line.

Phase 3 also runs flash at the shapes of phases 17-19 (head dim 256
with paligemma's prefix: its training shape, prefill chunks at offsets,
B=2 ragged, H == G on both CTAs; whisper's non-causal encoder and causal
decoder; gemma3's prefill chunks past the window), printing each bf16
case's CTA shape, and times the head-dim-256 kernel at paligemma's
training shape beside its bound, the plain version and SDPA with the
boolean prefix-LM mask, with the Function's gradients there.
Phase 3 also holds fused AdamW bitwise against its plain version (up
to qwen2-moe's stacked expert leaf of 692 M elements), the
RMSNorm, flash and SSD Functions' gradients against autograd through the
plain versions (flash and SSD once more at the training length), the
chunk body's kernels against their plain versions at the training shapes
of both models, where it times them, the SSD scan with a carried state
at mamba2's serving prefill shape (both routes, h0 = 0 bitwise the
launch without h0, timed beside the plain version and the bound), flash
at the sequence-chunked training shapes (q chunks of 1024 and 512 rows at every offset over a
2048-row KV-carry slot: o, lse, the Function's gradients with dK/dV
exactly 0 past the causal frontier, times beside SDPA given the boolean
mask and the bound; again at phase 16's deepseek-7b shape, 512-row
chunks of 32 heads of 128 over as many K/V heads, with rmsnorm at x
[512, 4096]), and the SSD scan at four shapes in fp32 and bf16,
each case's route printed and checked (bf16: the tensor-core passes,
fp32: the CUDA-core kernel).

Needs one CUDA card and imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores

SERVE_ARGV = ["--arch", "tinyllama-1.1b", "--full", "--pipelined", "1",
              "--slots", "4", "--chunk", "64", "--requests", "8",
              "--rate", "1e9", "--gen", "32", "--gen-min", "16",
              "--prompt-len", "224", "--device", "cuda",
              "--kernels", "fused"]          # max_seq = 224 + 32 + 4 * 64


T0 = time.perf_counter()
_last = [T0]


def done(phase: str) -> None:
    """Print the phase's wall time and the run's so far."""
    now = time.perf_counter()
    print(f"[time] {phase}: {now - _last[0]:.1f} s (run {now - T0:.1f} s)",
          flush=True)
    _last[0] = now


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn`` call, free of host launch overhead:
    ``reps`` calls captured in a CUDA graph, replayed ``iters`` times.
    Inputs that fit in the L2 stay there from call to call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def cold_ms(fn, inputs, iters: int = 5) -> float:
    """Device time of one ``fn(*args)`` call whose inputs come from device
    memory, not the L2: ``inputs`` is a list of argument tuples on
    distinct buffers, together several times the L2 (see
    :func:`rotating`); one call on each is captured in a CUDA graph, every
    output kept, so that each call reads buffers evicted since their last
    use and writes buffers of its own.  The graph is replayed ``iters``
    times."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in inputs[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [fn(*args) for args in inputs]
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        g.replay()
    end.record()
    end.synchronize()
    del outs, g
    return start.elapsed_time(end) / (iters * len(inputs))


def rotating(torch, args, times_l2: int = 4):
    """Copies of the tuple of tensors ``args``, as many as make their
    bytes ``times_l2`` times the card's L2 (at least 2)."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 0) or 50 * 2 ** 20
    nbytes = sum(a.numel() * a.element_size() for a in args)
    n = max(2, -(-times_l2 * l2 // nbytes))
    return [tuple(a.clone() for a in args) for _ in range(n)]


def rmsnorm_times(torch, x, scale, eps: float = 1e-6) -> dict:
    """rmsnorm_rows, its plain version and ``F.rms_norm`` at ``x``, each
    read from device memory (:func:`cold_ms`, the numbers the kernels line
    carries) and, as a second reading, with ``x`` left in the L2 by the
    call before (:func:`graph_ms`), in ms."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm_rows, rmsnorm_rows_ref
    d = x.shape[-1]
    sets = rotating(torch, (x, scale))
    lib = hasattr(F, "rms_norm")
    t = {"ms": cold_ms(lambda a, b: rmsnorm_rows(a, b, eps), sets),
         "plain_ms": cold_ms(lambda a, b: rmsnorm_rows_ref(a, b, eps), sets),
         "library_ms": cold_ms(lambda a, b: F.rms_norm(a, (d,), b, eps),
                               sets) if lib else None,
         "ms_l2_warm": graph_ms(lambda: rmsnorm_rows(x, scale, eps)),
         "library_ms_l2_warm": graph_ms(lambda: F.rms_norm(
             x, (d,), scale, eps)) if lib else None,
         "rotating_inputs": len(sets)}
    del sets
    return t


def rmsnorm_line(t: dict) -> str:
    """The times of :func:`rmsnorm_times` as one line, in us."""
    def us(v):
        return "n/a" if v is None else f"{v * 1e3:.2f} us"
    return (f"from device memory ({t['rotating_inputs']} rotating inputs, "
            f"CUDA graph): kernel {us(t['ms'])}, plain {us(t['plain_ms'])}, "
            f"F.rms_norm {us(t['library_ms'])}; L2-warm (one input, CUDA "
            f"graph): kernel {us(t['ms_l2_warm'])}, F.rms_norm "
            f"{us(t['library_ms_l2_warm'])}")


def max_err(got, want) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max())


def rel_ok(got, want, atol: float, rtol: float) -> bool:
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def phase_rmsnorm(torch, gen):
    from repro_torch.kernels.rmsnorm import rmsnorm_rows, rmsnorm_rows_ref
    d, eps = 2048, 1e-6
    # bf16 results may differ by one rounding step: 2^-7 relative
    tols = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-6, 2.0 ** -7)}
    worst = 0.0
    # d = 100: not a multiple of 8, the scalar loop in bf16; 25 vectors
    # of 4 in fp32
    for dt, (atol, rtol) in tols.items():
        for R, dd in ((1, d), (64, d), (300, d), (7, 100), (300, 100)):
            x = torch.randn((R, dd), generator=gen, device="cuda").to(dt)
            scale = (1 + 0.1 * torch.randn((dd,), generator=gen,
                                           device="cuda")).to(dt)
            got = rmsnorm_rows(x, scale, eps)
            torch.cuda.synchronize()
            want = rmsnorm_rows_ref(x, scale, eps)
            err = max_err(got, want)
            ok = rel_ok(got, want, atol, rtol)
            print(f"[kernels] rmsnorm_rows {str(dt)[6:]} R={R} d={dd}: "
                  f"max|d|={err:.3e} tol={atol:g}+{rtol:g}*|ref| "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"rmsnorm_rows disagrees with its plain version "
                     f"({dt}, R={R}, d={dd})")
            worst = max(worst, err)
    # main-path shape: one 64-token prefill chunk, bf16
    R, dt = 64, torch.bfloat16
    x = torch.randn((R, d), generator=gen, device="cuda").to(dt)
    scale = torch.ones((d,), dtype=dt, device="cuda")
    t = rmsnorm_times(torch, x, scale, eps)
    eager_ms = time_ms(lambda: rmsnorm_rows(x, scale, eps))
    nbytes = (2 * R * d + d) * x.element_size()
    flops = 4 * R * d
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": flops / FP32_FLOPS * 1e3}
    bound_by = max(bounds, key=bounds.get)
    print(f"[kernels] rmsnorm_rows timed at x [{R}, {d}] bf16 (device time "
          f"per call) {rmsnorm_line(t)}; eager call-to-call "
          f"{eager_ms * 1e3:.2f} us; bound {bounds[bound_by] * 1e3:.4f} us "
          f"({bound_by})")
    return {"name": "rmsnorm_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:18",
            "max_abs_err": worst, **t,
            "bound_ms": bounds[bound_by], "bound_by": bound_by,
            "eager_ms": eager_ms, "timed_shape": f"x [{R},{d}] bf16"}


def phase_rmsnorm_widths(torch, gen):
    """rmsnorm_rows at the widths of phases 17-19: gemma3's 5376,
    paligemma's 2048 and whisper's 512, bf16 and fp32, against the plain
    version at phase 3's tolerances; each launch's kernel, read from the
    profiler, says whether the width takes the vector path (rows of a
    16-byte multiple, at most 1280 vectors: 8 warps x 32 lanes x 5) or
    the scalar one."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rmsnorm import rmsnorm_rows, rmsnorm_rows_ref
    tols = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-6, 2.0 ** -7)}
    for d in (5376, 2048, 512):
        for dt, (atol, rtol) in tols.items():
            x = torch.randn((300, d), generator=gen, device="cuda").to(dt)
            scale = (1 + 0.1 * torch.randn((d,), generator=gen,
                                           device="cuda")).to(dt)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                got = rmsnorm_rows(x, scale)
                torch.cuda.synchronize()
            names = {e.key for e in prof.key_averages()
                     if "rmsnorm_rows_kernel" in e.key}
            route = ("vector" if any("_vec" in n for n in names)
                     else "scalar" if names else "not seen by the profiler")
            want = rmsnorm_rows_ref(x, scale)
            ok = rel_ok(got, want, atol, rtol)
            print(f"[kernels] rmsnorm_rows {str(dt)[6:]} R=300 d={d}: "
                  f"max|d|={max_err(got, want):.3e} tol={atol:g}+{rtol:g}"
                  f"*|ref| {'ok' if ok else 'FAIL'}; {route} path")
            if not ok:
                fail(f"rmsnorm_rows disagrees with its plain version at "
                     f"d={d}")


def _visible_pairs(Sq, Sk, q_offset, window, prefix):
    """(visible (q, k) pairs, kv rows the visible pairs touch), causal."""
    pairs, k_rows = 0, 0
    for i in range(Sq):
        qp = q_offset + i
        hi = min(qp, Sk - 1)                        # causal: k <= q
        lo = max(0, qp - window + 1) if window else 0
        ks = set(range(lo, hi + 1)) if hi >= lo else set()
        if prefix:
            ks |= set(range(min(prefix, Sk)))
        pairs += len(ks)
        if ks:
            k_rows = max(k_rows, max(ks) + 1)
    return pairs, k_rows


def cta_desc(d: int, nw: int) -> str:
    """The bf16 kernel's CTA shape at head dim ``d`` and ``nw`` warps."""
    bn, qs = (32, True) if d > 128 else (64, False)
    return (f"{16 * nw} q rows in {nw} warp(s), {bn}-row K/V tiles, Q "
            f"{'staged in shared memory, ldmatrix per k16 step' if qs else 'in registers'}")


def mma_smem_kb(d: int, nw: int) -> float:
    """Dynamic shared memory of ``flash_fwd_kernel_mma<d, nw>``, KB: the
    two-stage K/V ring, plus the Q tile at d > 128."""
    bn = 32 if d > 128 else 64
    return (2 * 2 * bn + (16 * nw if d > 128 else 0)) * d * 2 / 1024


# flash cases beyond the serving ones: (B, Sq, H, Sk, G, d, q_offset,
# window, prefix, causal)
FLASH_A4_CASES = [
    # paligemma-3b at head dim 256: the training shape (2304 = 256
    # patches + 2048 tokens, prefix 256), prefill chunks over a cache
    # with the patch prefix, B=2 ragged, H == G on both CTAs, and every
    # mask at once
    (1, 2304, 8, 2304, 1, 256, 0, 0, 256, True),
    (1, 384, 8, 1024, 1, 256, 0, 0, 256, True),
    (1, 128, 8, 1024, 1, 256, 384, 0, 256, True),
    (1, 64, 8, 1024, 1, 256, 700, 0, 256, True),
    (2, 100, 8, 300, 2, 256, 200, 0, 16, True),
    (2, 256, 8, 512, 8, 256, 100, 0, 0, True),
    (2, 512, 16, 512, 16, 256, 0, 0, 0, True),
    (2, 500, 16, 700, 4, 256, 200, 96, 40, True),
    # whisper-base: the encoder (1500 frames, non-causal, not a tile
    # multiple) and the decoder's 448 positions
    (8, 1500, 8, 1500, 8, 64, 0, 0, 0, False),
    (8, 448, 8, 448, 8, 64, 0, 0, 0, True),
    # gemma3-27b's prefill chunks past the 1024-token window over its
    # 2080-slot cache
    (1, 128, 32, 2080, 16, 128, 1152, 1024, 0, True),
    (1, 128, 32, 2080, 16, 128, 1408, 1024, 0, True),
]


def phase_flash(torch, gen):
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
    import torch.nn.functional as F
    tols = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-2, 1e-5)}
    # (B, Sq, H, Sk, G, d, q_offset, window, prefix)
    cases = [(1, 64, 32, 512, 4, 64, 0, 0, 0),
             (1, 64, 32, 512, 4, 64, 64, 0, 0),
             (1, 64, 32, 512, 4, 64, 448, 0, 0),
             (1, 64, 32, 500, 4, 64, 436, 0, 0),   # Sk not a tile multiple
             (1, 64, 32, 512, 4, 64, 448, 128, 0),  # sliding window
             (1, 64, 32, 512, 4, 64, 64, 0, 16),   # prefix
             (1, 50, 32, 512, 4, 64, 128, 0, 0),   # ragged q tile
             (1, 64, 8, 512, 2, 16, 64, 0, 0),     # reduced config's hd
             (1, 64, 32, 512, 4, 32, 192, 0, 0),   # hd 32
             (1, 64, 32, 512, 4, 128, 192, 0, 0),  # hd 128 (64 KB ring)
             (2, 100, 16, 300, 4, 128, 200, 64, 16),   # B=2, hd 128, mixed
             (2, 64, 8, 512, 8, 64, 100, 0, 0),    # B=2, H == G
             (1, 2047, 32, 2047, 4, 64, 0, 0, 0),  # ragged Sk, training len
             # every row sees no key (window 2, queries past the 8-key
             # buffer): o is the mean of v, as in attention_ref
             (1, 16, 8, 8, 2, 64, 20, 2, 0),
             # grids that fill the card, so bf16 runs the 4-warp CTA: its
             # per-CTA key range, per-warp skip and edge-tile test
             (2, 512, 32, 512, 4, 128, 0, 128, 0),   # hd 128, window
             (2, 512, 32, 512, 4, 128, 0, 0, 64),    # hd 128, prefix
             (2, 500, 32, 700, 4, 128, 200, 96, 40),  # hd 128, all, ragged
             (2, 512, 32, 512, 4, 32, 0, 128, 0),    # hd 32, window
             (2, 512, 32, 512, 4, 32, 0, 0, 64),     # hd 32, prefix
             (2, 256, 32, 256, 32, 16, 0, 0, 0),     # hd 16, H == G
             # qwen2-moe's MHA 16 x 128: a serving prefill chunk at an
             # offset over the 512-slot cache, and the training length
             (1, 64, 16, 512, 16, 128, 192, 0, 0),
             (1, 64, 16, 512, 16, 128, 448, 0, 0),
             (1, TRAIN_SEQ - 1, 16, TRAIN_SEQ - 1, 16, 128, 0, 0, 0)]
    cases = [c + (True,) for c in cases] + FLASH_A4_CASES
    lib = build.load_library()
    ran = set()   # (d, warps per CTA, window, prefix) of the bf16 cases
    worst, worst_lse = 0.0, 0.0
    for dt, (tol_o, tol_lse) in tols.items():
        for B, Sq, H, Sk, G, d, off, win, pre, causal in cases:
            nw = lib.flash_attention_fwd_warps(
                B, Sq, H, build.DTYPE_CODES[str(dt)[6:]])
            kern = f"flash_fwd_kernel_mma<{d},{nw}>: {cta_desc(d, nw)}" \
                if nw else f"flash_fwd_kernel<{d}>"
            if nw:
                ran.add((d, nw, bool(win), bool(pre)))
            q = torch.randn((B, Sq, H, d), generator=gen,
                            device="cuda").to(dt)
            k = torch.randn((B, Sk, G, d), generator=gen,
                            device="cuda").to(dt)
            v = torch.randn((B, Sk, G, d), generator=gen,
                            device="cuda").to(dt)
            o, lse = flash_attention_fwd(q, k, v, causal=causal, window=win,
                                         prefix=pre, q_offset=off)
            torch.cuda.synchronize()
            o_ref, lse_ref = attention_ref(q, k, v, causal=causal,
                                           window=win, prefix=pre,
                                           q_offset=off)
            e_o, e_l = max_err(o, o_ref), max_err(lse, lse_ref)
            ok = e_o <= tol_o and e_l <= tol_lse
            print(f"[kernels] flash_attention_fwd {str(dt)[6:]} q [{B},{Sq},"
                  f"{H},{d}] kv [{B},{Sk},{G},{d}] off={off} window={win} "
                  f"prefix={pre} causal={causal} [{kern}]: max|d| "
                  f"o={e_o:.3e} (tol "
                  f"{tol_o:g}) "
                  f"lse={e_l:.3e} (tol {tol_lse:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail("flash_attention_fwd disagrees with attention_ref")
            worst, worst_lse = max(worst, e_o), max(worst_lse, e_l)
    need = {(d, nw) for d in HEAD_DIMS for nw in (1, 4)} | {
        (d, 4, True, False) for d in (32, 128)} | {
        (d, 4, False, True) for d in (32, 128)}
    have = {r[:2] for r in ran} | ran
    if not need <= have:
        fail(f"flash_attention_fwd: phase 3 did not run the bf16 CTAs "
             f"{sorted(need - have)}")
    print("[kernels] flash_fwd_kernel_mma (bf16) dynamic shared memory, "
          "the K/V ring of 2 stages x 64 rows (32 at D=256, plus the Q "
          "tile): " + ", ".join(
              f"{mma_smem_kb(d, 4):g} KB at D={d} (4 warps)"
              for d in HEAD_DIMS) + f", {mma_smem_kb(256, 1):g} KB at "
          "D=256 (1 warp)")
    # main-path shape: a 64-token prefill chunk at offset 192 (the last
    # chunk of a 256-token prompt) over the 512-slot bf16 cache
    Sq, H, Sk, G, d, off, dt = 64, 32, 512, 4, 64, 192, torch.bfloat16
    q = torch.randn((1, Sq, H, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((1, Sk, G, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((1, Sk, G, d), generator=gen, device="cuda").to(dt)
    ms = graph_ms(lambda: flash_attention_fwd(q, k, v, q_offset=off))
    eager_ms = time_ms(lambda: flash_attention_fwd(q, k, v, q_offset=off))
    plain_ms = graph_ms(lambda: attention_ref(q, k, v, q_offset=off))
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous()
    pos_q = off + torch.arange(Sq, device="cuda")[:, None]
    mask = torch.arange(Sk, device="cuda")[None, :] <= pos_q
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    pairs, k_rows = _visible_pairs(Sq, Sk, off, 0, 0)
    el = q.element_size()
    nbytes = 2 * Sq * H * d * el + 2 * k_rows * G * d * el + H * Sq * 4
    flops = 4 * H * d * pairs
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": flops / BF16_FLOPS * 1e3}
    bound_by = max(bounds, key=bounds.get)
    print(f"[kernels] flash_attention_fwd timed at q [1,{Sq},{H},{d}] kv "
          f"[1,{Sk},{G},{d}] bf16 q_offset={off} (device time per call, "
          f"CUDA graph): kernel {ms * 1e3:.2f} us (eager call-to-call "
          f"{eager_ms * 1e3:.2f} us), "
          f"plain {plain_ms * 1e3:.2f} us, SDPA {lib_ms * 1e3:.2f} us, "
          f"bound {bounds[bound_by] * 1e3:.4f} us ({bound_by}; {pairs} "
          f"visible pairs per head, {k_rows} kv rows)")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:98",
            "max_abs_err": worst, "lse_max_abs_err": worst_lse, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bounds[bound_by],
            "bound_by": bound_by, "library_ms": lib_ms, "eager_ms": eager_ms,
            "timed_shape": f"q [1,{Sq},{H},{d}] kv [1,{Sk},{G},{d}] bf16 "
                           f"q_offset={off}"}


def serve_launches(cfg, n_prefill: int, n_decode: int) -> dict:
    """Kernel launches of serving ``n_prefill`` chunks and ``n_decode``
    decode ticks: every tick runs rmsnorm for each layer's ``norm1``, a
    Mamba-2 layer's gated norm and ``norm2`` where the layer has an FFN
    (MLP or MoE); every prefill chunk runs flash in each attention layer
    and the SSD scan, from the slot's carried state, in each Mamba-2
    layer.  Decode takes the dense attention path and the plain
    recurrence; the head's final norm is the plain one."""
    L = cfg.num_layers
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(L))
    mamba = L - attn
    ffn = sum(cfg.layer_is_moe(i) or cfg.d_ff > 0 for i in range(L))
    return {"rmsnorm_rows": (L + mamba + ffn) * (n_prefill + n_decode),
            "flash_attention_fwd": attn * n_prefill,
            "fused_adamw_flat": 0, "ssd_scan": mamba * n_prefill}


class PlainScanCounter:
    """Counts the calls of ``ssd_chunked_ref`` (the SSD scan's plain
    version) through every module that can reach it, while active."""
    MODULES = ("repro_torch.kernels.ssd_scan.ops",
               "repro_torch.models.backend", "repro_torch.models.mamba")

    def __enter__(self):
        import importlib
        self.calls, self.saved = 0, []
        for name in self.MODULES:
            mod = importlib.import_module(name)
            orig = mod.ssd_chunked_ref

            def counted(*a, _orig=orig, **k):
                self.calls += 1
                return _orig(*a, **k)
            self.saved.append((mod, orig))
            mod.ssd_chunked_ref = counted
        return self

    def __exit__(self, *exc):
        for mod, orig in self.saved:
            mod.ssd_chunked_ref = orig


def serve_argv(arch: str, chunk: int = 64, prompt_chunks: int = 4,
               prompt_len: int = 224):
    """Phase 4's traffic for ``arch``: 8 requests at once, 4 slots,
    prompts of 1 to ``prompt_chunks`` chunks of ``chunk`` tokens, 16 to
    32 new tokens, greedy, full width, fused kernels; the defaults are
    phase 4's own."""
    argv = list(SERVE_ARGV)
    for flag, val in (("--arch", arch), ("--chunk", str(chunk)),
                      ("--prompt-len", str(prompt_len))):
        argv[argv.index(flag) + 1] = val
    return argv + ["--prompt-chunks", str(prompt_chunks)]


def decode_bound_ms(eng) -> tuple:
    """(bytes, ms) a decode tick must move at the least: every layer
    weight of the engine's blocks and the head, read once at 3.35 TB/s
    (an MoE layer's capacity dispatch runs every expert, so all of its
    experts are read), K/V, conv tails and states not counted."""
    from repro_torch.tree import tree_leaves
    emb = eng.shared["embed"]
    head = emb.get("head", emb["tokens"])
    nbytes = sum(a.numel() * a.element_size()
                 for a in tree_leaves(eng.blocks)) \
        + head.numel() * head.element_size()
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def phase_serve(torch, argv=None, tag="serve"):
    """``argv`` (default :data:`SERVE_ARGV`) through the CLI's ``main``:
    every request completes with its token count, finite logits, the
    stage runs and every kernel's launches as :func:`serve_launches`
    derives them, and no call of the SSD scan's plain version.  Returns
    the launch counts, the engine and the run's summary (with its peak
    memory)."""
    from repro_torch.launch.serve import main as serve_main
    argv = SERVE_ARGV if argv is None else argv
    kernels = _kernel_fns()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    with PlainScanCounter() as plain:
        out = serve_main(argv)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    s, res, reqs, cfg, eng = (out["summary"], out["result"], out["requests"],
                              out["config"], out["engine"])
    chunk = eng.chunk
    n_prefill = sum(len(r.prompt) // chunk for r in reqs)
    n_decode = sum(r.max_new - 1 for r in reqs)
    dbytes, dms = decode_bound_ms(eng)
    print(f"[{tag}] {cfg.name} full width bf16, chunk {chunk}: requests="
          f"{s['requests']} prefill_chunks={n_prefill} decode_ticks="
          f"{n_decode} ticks={s['ticks']} tokens/s={s['tokens_per_s']:.2f} "
          f"ttft p50={s['ttft_p50_s'] * 1e3:.2f}ms "
          f"p99={s['ttft_p99_s'] * 1e3:.2f}ms per-token "
          f"p50={s['tok_p50_s'] * 1e3:.3f}ms p99={s['tok_p99_s'] * 1e3:.3f}ms"
          f" max_memory_allocated={peak / 2 ** 30:.3f}GiB (after: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f}GiB allocated)")
    print(f"[{tag}] decode-tick bound: {dbytes / 1e9:.2f} GB of weights "
          f"read once = {dms:.3f} ms at 3.35 TB/s, against the per-token "
          f"p50 {s['tok_p50_s'] * 1e3:.3f} ms")
    print(f"[{tag}] launches {launches}; ssd_chunked_ref calls "
          f"{plain.calls}")
    if len(reqs) != 8 or set(res["finished"]) != {r.rid for r in reqs}:
        fail(f"not every request completed: {sorted(res['finished'])}")
    for r in reqs:
        got = len(res["finished"][r.rid].tokens)
        if got != r.max_new:
            fail(f"request {r.rid} got {got} tokens, asked {r.max_new}")
    if res["nonfinite_logits"]:
        fail(f"{res['nonfinite_logits']} sampled waves had non-finite logits")
    if res["stage_runs"] != {"prefill": n_prefill, "decode": n_decode}:
        fail(f"stage runs {res['stage_runs']} != prefill {n_prefill}, "
             f"decode {n_decode}")
    want = serve_launches(cfg, n_prefill, n_decode)
    if launches != want:
        fail(f"kernel launches {launches} != expected {want}")
    if plain.calls:
        fail(f"the serve path called the SSD scan's plain version "
             f"{plain.calls} times")
    return launches, eng, {**s, "peak": peak, "decode_bound_ms": dms}


def phase_profile(torch, eng, tag="serve"):
    """Where the serve path's time goes, on the warm engine of a serve
    phase: 4 more requests of 8 new tokens each served once with tracing
    off (the warm end-to-end numbers), then the same 4 again under
    ``torch.profiler``
    for the device busy share and the device time by kernel family.  The
    ratio of the two wall times is the profiler's overhead."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import poisson_requests, summarize
    reqs = poisson_requests(4, 1e9, chunk=eng.chunk, max_seq=eng.max_seq,
                            gen_range=(8, 8), vocab=eng.cfg.vocab_size,
                            seed=1)
    warm = summarize(eng.serve(reqs))
    print(f"[{tag}-warm] same engine, {warm['requests']} more requests, "
          f"tracing off: tokens/s={warm['tokens_per_s']:.2f} "
          f"ticks={warm['ticks']} wall/tick="
          f"{warm['elapsed_s'] / warm['ticks'] * 1e3:.3f}ms "
          f"ttft p50={warm['ttft_p50_s'] * 1e3:.2f}ms "
          f"per-token p50={warm['tok_p50_s'] * 1e3:.3f}ms "
          f"p99={warm['tok_p99_s'] * 1e3:.3f}ms")
    # device activity only: a mamba2 tick's host ops number in the
    # thousands and would take minutes to read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.serve(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    fams = {"rmsnorm_rows (ours)": 0.0, "flash_attention_fwd (ours)": 0.0,
            "ssd_scan (ours)": 0.0, "matmul": 0.0, "other": 0.0}
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue                  # host ops; their kernels are listed
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev <= 0:
            continue
        rows.append((dev, e.count, e.key))
        name = e.key.lower()
        if "rmsnorm_rows_kernel" in name:
            fams["rmsnorm_rows (ours)"] += dev
        elif "flash_fwd_kernel" in name:
            fams["flash_attention_fwd (ours)"] += dev
        elif "ssd_scan_kernel" in name:
            fams["ssd_scan (ours)"] += dev
        elif any(t in name for t in ("gemm", "gemv", "xmma", "cutlass",
                                     "nvjet", "cublas")):
            fams["matmul"] += dev
        else:
            fams["other"] += dev
    busy = sum(fams.values())
    ticks = res["ticks"]
    if busy <= 0:
        print(f"[profile-{tag}] the profiler reported no device time: "
              "device breakdown not measured")
        return
    print(f"[profile-{tag}] serve of {len(reqs)} requests, {ticks} ticks, "
          f"{sum(len(r.tokens) for r in res['finished'].values())} tokens: "
          f"wall {wall_us / 1e3:.1f} ms (profiled; "
          f"{wall_us / 1e6 / warm['elapsed_s']:.2f}x the untraced run), "
          f"device busy "
          f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% of wall, "
          f"idle {100 - 100 * busy / wall_us:.1f}%; "
          f"{wall_us / ticks / 1e3:.2f} ms wall per tick")
    for fam, us in fams.items():
        print(f"[profile-{tag}]   {fam}: {us / 1e3:.2f} ms "
              f"({100 * us / busy:.1f}% of device time)")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        print(f"[profile-{tag}]   top: {dev / 1e3:8.2f} ms x{count:<6d} "
              f"{key[:90]}")


def phase_serve_family(torch, argv, tag, launches, key):
    """Full width served from ``argv`` (:func:`serve_argv`) through
    :func:`phase_serve`, gated as phase 4, its launches under
    ``launches[key]``; its warm re-run and profile; then phase 5's
    checks on the same architecture and chunk."""
    gc.collect()
    torch.cuda.empty_cache()
    launches[key], eng, _ = phase_serve(torch, argv, tag)
    arch, chunk = eng.cfg.name, eng.chunk
    phase_profile(torch, eng, tag)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    phase_checks(torch, arch, chunk, f"{tag}-check")


def phase_checks(torch, arch="tinyllama-1.1b", chunk=64, tag="check"):
    """(a) P=2 virtual stages give P=1's token streams (2 requests of one
    and two chunks, 8 new tokens each); (b) full width, fp32, 2 layers:
    the fused and plain backends agree on the logits of two prefill
    chunks and four decode steps within 1e-3."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve import PipelinedEngine, Request
    cfg = get_config(arch)
    # (a) P=2 virtual stages vs P=1 on the same card: identical streams
    lm = LM(cfg, device="cuda")
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(rid=i, prompt=torch.randint(
        0, cfg.vocab_size, (chunk * (i + 1),), generator=rng).tolist(),
        max_new=8) for i in range(2)]
    streams = {}
    for P in (1, 2):
        eng = PipelinedEngine(cfg, params, P=P, chunk=chunk,
                              max_seq=4 * chunk, n_slots=2, device="cuda")
        res = eng.serve(reqs, clock=None)
        streams[P] = {rid: rec.tokens for rid, rec in res["finished"].items()}
        del eng
    print(f"[{tag}] {cfg.name}: P=2 streams "
          f"{'==' if streams[1] == streams[2] else '!='} P=1 streams: "
          f"{streams[1]}")
    if streams[1] != streams[2]:
        fail(f"{arch}: P=2 token streams {streams[2]} differ from P=1 "
             f"{streams[1]}")
    del params, lm
    gc.collect()
    torch.cuda.empty_cache()
    # (b) full width, fp32, 2 layers: fused kernels vs plain backend
    cfg32 = dataclasses.replace(cfg, num_layers=2, param_dtype="float32",
                                compute_dtype="float32")
    fused = LM(cfg32, kernels="fused", device="cuda")
    plain = LM(cfg32, kernels="plain", device="cuda")
    params = fused.init(torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (1, 2 * chunk), generator=rng
                           ).to("cuda")
    caches = {"fused": fused.init_cache(1, 4 * chunk),
              "plain": plain.init_cache(1, 4 * chunk)}
    worst, steps = 0.0, 0
    tok = None
    pos = 0
    for step in range(6):          # 2 prefill chunks, then 4 decode steps
        logits = {}
        for name, lm_ in (("fused", fused), ("plain", plain)):
            if step < 2:
                logits[name], _ = lm_.prefill_chunk(
                    params, prompt[:, chunk * step:chunk * (step + 1)],
                    caches[name], pos)
            else:
                logits[name], _ = lm_.decode_step(params, tok, caches[name],
                                                  pos)
        if not bool(torch.isfinite(logits["fused"]).all()):
            fail("non-finite fp32 logits")
        if logits["fused"].shape != (1, cfg.vocab_size):
            fail(f"logits shape {tuple(logits['fused'].shape)}")
        worst = max(worst, max_err(logits["fused"], logits["plain"]))
        pos += chunk if step < 2 else 1
        tok = logits["fused"].argmax(-1, keepdim=True)   # teacher forcing
        steps += 1
    tol = 1e-3
    print(f"[{tag}] {cfg.name} fp32 full width 2 layers, fused vs plain "
          f"logits over {steps} steps: max|d|={worst:.3e} (tol {tol:g})")
    if not worst <= tol:
        fail(f"{arch}: fused and plain backends disagree on fp32 logits")
    del fused, plain, params, caches
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training slice: fused AdamW, the differentiable kernel calls, the
# ChronosPipe training step
# ---------------------------------------------------------------------------

ADAMW_STATE_BYTES = 24         # mu, nu, w read and written, fp32
ADAMW_FLOPS = 16               # per element, csrc/fused_adamw.cu
TRAIN_SEQ = 2049               # 2048 positions per sequence fed to the stack
# mamba2-2.7b's pipeline runs (phases 8 and 11) at full width, cut to 16
# of its 64 layers so that the whole smoke, with phases 17-20, keeps well
# inside its time limit on a slow host (an H100 run took 1064.5 s with 32)
MAMBA2_TRAIN_LAYERS = 16
# the sequence-chunked runs (phases 13-14) at full width, cut to 8 of
# tinyllama-1.1b's 22 layers: their host-paced steps and long traces
# (seq1f1b: 84.2 s at 22 layers) made room for phases 21-22
SEQ_TRAIN_LAYERS = 8
# (tag, TrainConfig, P, peak bytes) of every pipeline training run, for
# phase 16's predicted-against-measured lines
TRAIN_RUNS = []


def _adamw_case(torch, gen, n, g_dtype, step, wd):
    """(kernel inputs, plain inputs, hyper): one random AdamW state."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.optim.schedules import lr_at
    ocfg = OptimizerConfig(warmup_steps=2, total_steps=20)
    st = torch.tensor(step, dtype=torch.int32, device="cuda")
    stepf = st.float()
    scalars = torch.stack([lr_at(ocfg, st), 1 - torch.pow(ocfg.beta1, stepf),
                           1 - torch.pow(ocfg.beta2, stepf)]).float()
    g = torch.randn((n,), generator=gen, device="cuda").to(g_dtype)
    mu = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    nu = 0.01 * torch.rand((n,), generator=gen, device="cuda")
    w = torch.randn((n,), generator=gen, device="cuda")
    hyper = dict(b1=ocfg.beta1, b2=ocfg.beta2, eps=ocfg.eps, wd=wd)
    return (g, mu, nu, w, scalars), hyper


def phase_adamw(torch, gen):
    """fused_adamw_flat against its plain version, bitwise, then timed at
    tinyllama's largest leaf (the stacked ``wi``)."""
    from repro_torch.kernels.fused_adamw import (fused_adamw_flat,
                                                 fused_adamw_flat_ref)
    cases = 0
    for n in (1, 1000, 65537, 2 ** 24 + 3):
        for g_dt in (torch.float32, torch.bfloat16):
            for step in (1, 10):
                for wd in (0.0, 0.1):
                    (g, mu, nu, w, sc), hp = _adamw_case(torch, gen, n, g_dt,
                                                         step, wd)
                    k = [a.clone() for a in (mu, nu, w)]
                    fused_adamw_flat(g, *k, sc, **hp)
                    torch.cuda.synchronize()
                    fused_adamw_flat_ref(g, mu, nu, w, sc, **hp)
                    same = all(torch.equal(a, b) for a, b in
                               zip(k, (mu, nu, w)))
                    if not same:
                        errs = [max_err(a, b) for a, b in zip(k, (mu, nu, w))]
                        fail(f"fused_adamw_flat n={n} g {g_dt} step={step} "
                             f"wd={wd} is not bitwise equal to its plain "
                             f"version: max|d| mu, nu, w = {errs}")
                    cases += 1
    print(f"[kernels] fused_adamw_flat: {cases} cases (n in 1, 1000, 65537, "
          f"2^24+3; g fp32 and bf16; step 1 and 10; wd 0 and 0.1) bitwise "
          f"equal to fused_adamw_flat_ref (tol 0)")
    # qwen2-moe's stacked expert leaf wi [P=2, v=2, M=1, 60, 2048, 1408]
    # (phase 15a), and 3 more elements for the scalar tail at that size
    big = 4 * 60 * 2048 * 1408
    for n in (big, big + 3):
        for g_dt in (torch.float32, torch.bfloat16):
            (g, mu, nu, w, sc), hp = _adamw_case(torch, gen, n, g_dt, 10,
                                                 0.1)
            k = [a.clone() for a in (mu, nu, w)]
            fused_adamw_flat(g, *k, sc, **hp)
            torch.cuda.synchronize()
            fused_adamw_flat_ref(g, mu, nu, w, sc, **hp)
            same = all(torch.equal(a, b) for a, b in zip(k, (mu, nu, w)))
            print(f"[kernels] fused_adamw_flat n={n} (qwen2-moe expert wi"
                  f"{' + 3' if n > big else ''}) g {str(g_dt)[6:]}: "
                  f"{'bitwise equal to' if same else 'DIFFERS from'} "
                  f"fused_adamw_flat_ref (tol 0)")
            if not same:
                errs = [max_err(a, b) for a, b in zip(k, (mu, nu, w))]
                fail(f"fused_adamw_flat n={n} g {g_dt} is not bitwise equal "
                     f"to its plain version: max|d| mu, nu, w = {errs}")
            del g, mu, nu, w, k
            torch.cuda.empty_cache()
    # main-path shape: the stacked wi leaf [P=4, v=2, M=3, 2048, 5632]
    n = 4 * 2 * 3 * 2048 * 5632
    (g, mu, nu, w, sc), hp = _adamw_case(torch, gen, n, torch.float32, 10,
                                         0.1)
    ms = time_ms(lambda: fused_adamw_flat(g, mu, nu, w, sc, **hp),
                 iters=20, warmup=3)
    plain_ms = time_ms(lambda: fused_adamw_flat_ref(g, mu, nu, w, sc, **hp),
                       iters=5, warmup=1)
    nbytes = (g.element_size() + ADAMW_STATE_BYTES) * n
    flops = ADAMW_FLOPS * n
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": flops / FP32_FLOPS * 1e3}
    bound_by = max(bounds, key=bounds.get)
    print(f"[kernels] fused_adamw_flat timed at n={n} (wi leaf) fp32 g "
          f"(device time per call, CUDA events): kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bounds[bound_by]:.3f} ms ({bound_by}; "
          f"{nbytes / 1e9:.2f} GB) = {ms / bounds[bound_by]:.2f}x bound; "
          f"no one-call PyTorch yardstick (torch._fused_adamw_ divides "
          f"sqrt(nu) by sqrt(bc2) before adding eps and decays w as "
          f"w*(1-lr*wd): another function)")
    del g, mu, nu, w
    torch.cuda.empty_cache()
    return {"name": "fused_adamw_flat", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_adamw.cu",
            "replaces": "src/repro/kernels/fused_adamw/kernel.py:32",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bounds[bound_by], "bound_by": bound_by,
            "library_ms": None,
            "timed_shape": f"n={n} (wi [4,2,3,2048,5632]) fp32 g"}


def phase_functions(torch, gen):
    """Gradients through the RMSNorm and flash-attention Functions (the
    kernel forward) against autograd through their plain versions."""
    from repro_torch.kernels.rmsnorm import rmsnorm_fused, rmsnorm_rows_ref
    # y within the forward tolerances of phase 3; gradients: the backward
    # differentiates the plain version at the same inputs, so they differ
    # only through the cotangent paths that read y (none: y is not saved)
    tols = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
    for dt, (tol_y, tol_g) in tols.items():
        x = torch.randn((2, 256, 2048), generator=gen, device="cuda").to(dt)
        s = (1 + 0.1 * torch.randn((2048,), generator=gen,
                                   device="cuda")).to(dt)
        dy = torch.randn_like(x)
        xs = [x.clone().requires_grad_(), x.clone().requires_grad_()]
        ss = [s.clone().requires_grad_(), s.clone().requires_grad_()]
        y1 = rmsnorm_fused(xs[0], ss[0])
        y2 = rmsnorm_rows_ref(xs[1].reshape(-1, 2048), ss[1]).reshape(x.shape)
        if y1.grad_fn is None:
            fail("rmsnorm_fused output carries no grad_fn")
        y1.backward(dy)
        y2.backward(dy)
        errs = (max_err(y1, y2), max_err(xs[0].grad, xs[1].grad),
                max_err(ss[0].grad, ss[1].grad) / max(
                    1.0, float(ss[1].grad.float().abs().max())))
        ok = errs[0] <= tol_y and max(errs[1:]) <= tol_g
        print(f"[kernels] RMSNormRows {str(dt)[6:]} x [2,256,2048]: "
              f"max|d| y={errs[0]:.3e} dx={errs[1]:.3e} dscale(rel)="
              f"{errs[2]:.3e} (tol y {tol_y:g}, grads {tol_g:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("RMSNormRows gradients disagree with the plain version's")
        _flash_grad_case(torch, gen, dt, 256, tol_y, tol_g)
    # once at the training length: 32 query tiles over 2048 keys, bf16
    _flash_grad_case(torch, gen, torch.bfloat16, TRAIN_SEQ - 1,
                     *tols[torch.bfloat16])


def _flash_grad_case(torch, gen, dt, S, tol_o, tol_g, H=32, G=4, d=64,
                     prefix=0):
    """o and dq, dk, dv of the flash Function against autograd through
    ``attention_ref`` at q [1,S,H,d] over kv [1,S,G,d] (causal, with
    ``prefix``); fails beyond the tolerances."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    q = torch.randn((1, S, H, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((1, S, G, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((1, S, G, d), generator=gen, device="cuda").to(dt)
    do = torch.randn_like(q)
    ins = [[a.clone().requires_grad_() for a in (q, k, v)] for _ in range(2)]
    o1 = flash_attention(*ins[0], prefix=prefix)
    o2, _ = attention_ref(*ins[1], prefix=prefix)
    if o1.grad_fn is None:
        fail("flash_attention output carries no grad_fn")
    o1.backward(do)
    o2.backward(do)
    errs = [max_err(o1, o2)] + [max_err(a.grad, b.grad)
                                for a, b in zip(*ins)]
    ok = errs[0] <= tol_o and max(errs[1:]) <= tol_g
    print(f"[kernels] FlashAttention {str(dt)[6:]} q [1,{S},{H},{d}] kv "
          f"[1,{S},{G},{d}] prefix={prefix}: max|d| o={errs[0]:.3e} "
          f"dq={errs[1]:.3e} "
          f"dk={errs[2]:.3e} dv={errs[3]:.3e} (tol o {tol_o:g}, grads "
          f"{tol_g:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("FlashAttention gradients disagree with the plain version's")


def phase_train_shapes(torch, gen, rows):
    """The two kernels of the chunk body at the training shapes, held
    against their plain versions and timed: flash at q [1,2048,32,64]
    over kv [1,2048,4,64] (static offset 0) and rmsnorm at x [2048,
    2048], bf16, with phase 3's tolerances."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    from repro_torch.kernels.rmsnorm import rmsnorm_rows, rmsnorm_rows_ref
    import torch.nn.functional as F
    S, H, G, d, dt = TRAIN_SEQ - 1, 32, 4, 64, torch.bfloat16
    q = torch.randn((1, S, H, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((1, S, G, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((1, S, G, d), generator=gen, device="cuda").to(dt)
    o, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    o_ref, lse_ref = attention_ref(q, k, v)
    e_o, e_l = max_err(o, o_ref), max_err(lse, lse_ref)
    ok = e_o <= 2e-2 and e_l <= 1e-5
    print(f"[kernels] flash_attention_fwd bf16 q [1,{S},{H},{d}] kv "
          f"[1,{S},{G},{d}] off=0 (the training shape): max|d| o={e_o:.3e} "
          f"(tol 0.02) lse={e_l:.3e} (tol 1e-05) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("flash_attention_fwd disagrees with attention_ref at the "
             "training shape")
    del o, lse, o_ref, lse_ref
    ms = time_ms(lambda: flash_attention_fwd(q, k, v), iters=20, warmup=3)
    plain_ms = time_ms(lambda: attention_ref(q, k, v), iters=5, warmup=1)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=20, warmup=3)
    pairs = S * (S + 1) // 2
    el = q.element_size()
    nbytes = 2 * S * H * d * el + 2 * S * G * d * el + H * S * 4
    flops = 4 * H * d * pairs
    fb = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
          "operations": flops / BF16_FLOPS * 1e3}
    fby = max(fb, key=fb.get)
    print(f"[kernels] flash_attention_fwd timed at the training shape q "
          f"[1,{S},{H},{d}] kv [1,{S},{G},{d}] bf16 q_offset=0 (CUDA events):"
          f" kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s achieved), "
          f"plain {plain_ms:.3f} ms, SDPA (is_causal, GQA) {lib_ms:.3f} ms "
          f"({flops / lib_ms / 1e9:.1f} TFLOP/s; kernel = "
          f"{ms / lib_ms:.2f}x SDPA), bound {fb[fby] * 1e3:.2f} us ({fby}; "
          f"{flops / 1e9:.2f} GFLOP) = {ms / fb[fby]:.1f}x bound")
    from repro_torch.kernels.flash_attention import flash_attention
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    o = flash_attention(*leaves)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(dt)
    bwd_ms = time_ms(lambda: torch.autograd.grad(o, leaves, do,
                                                 retain_graph=True),
                     iters=5, warmup=1)
    del o, leaves
    print(f"[kernels] the FlashAttention backward (plain VJP, recomputing "
          f"attention_ref) at the training shape: {bwd_ms:.3f} ms")
    rows["flash_attention_fwd"]["train"] = {
        "max_abs_err": e_o, "lse_max_abs_err": e_l, "ms": ms,
        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": fb[fby],
        "bound_by": fby, "plain_bwd_ms": bwd_ms,
        "timed_shape": f"q [1,{S},{H},{d}] kv [1,{S},{G},{d}] bf16 "
                       f"q_offset=0"}
    x = torch.randn((S, 2048), generator=gen, device="cuda").to(dt)
    scale = (1 + 0.1 * torch.randn((2048,), generator=gen,
                                   device="cuda")).to(dt)
    got = rmsnorm_rows(x, scale)
    torch.cuda.synchronize()
    want = rmsnorm_rows_ref(x, scale)
    e_r = max_err(got, want)
    ok = rel_ok(got, want, 1e-6, 2.0 ** -7)
    print(f"[kernels] rmsnorm_rows bf16 R={S} d=2048 (the training shape): "
          f"max|d|={e_r:.3e} tol=1e-06+0.0078125*|ref| "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("rmsnorm_rows disagrees with its plain version at the training "
             "shape")
    t = rmsnorm_times(torch, x, scale)
    nbytes = (2 * S * 2048 + 2048) * x.element_size()
    rb = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
          "operations": 4 * S * 2048 / FP32_FLOPS * 1e3}
    rby = max(rb, key=rb.get)
    print(f"[kernels] rmsnorm_rows timed at the training shape x [{S},2048] "
          f"bf16 {rmsnorm_line(t)}; bound {rb[rby] * 1e3:.3f} us ({rby})")
    rows["rmsnorm_rows"]["train"] = {
        "max_abs_err": e_r, **t, "bound_ms": rb[rby], "bound_by": rby,
        "timed_shape": f"x [{S},2048] bf16"}


PALI_PREFIX = 256               # paligemma-3b's patches


def prefix_causal_pairs(S: int, prefix: int) -> int:
    """Visible (q, k) pairs of one head under the causal prefix-LM mask
    over S positions: a row below the prefix sees the whole prefix, a
    later row its own causal past."""
    return prefix * prefix + sum(i + 1 for i in range(prefix, S))


def phase_flash_d256(torch, gen, rows):
    """Flash at head dim 256, paligemma-3b's training shape (q [1, 2304,
    8, 256] over kv [1, 2304, 1, 256], prefix 256, causal, bf16): held
    against ``attention_ref`` (phase 3's tolerances), timed by CUDA-graph
    replay beside the plain version, SDPA (given the boolean prefix-LM
    mask) and the bound; the Function's gradients once against autograd
    through the plain version."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    import torch.nn.functional as F
    S, H, G, d, pre, dt = PALI_PREFIX + TRAIN_SEQ - 1, 8, 1, 256, \
        PALI_PREFIX, torch.bfloat16
    q = torch.randn((1, S, H, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((1, S, G, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((1, S, G, d), generator=gen, device="cuda").to(dt)
    o, lse = flash_attention_fwd(q, k, v, prefix=pre)
    torch.cuda.synchronize()
    o_ref, lse_ref = attention_ref(q, k, v, prefix=pre)
    e_o, e_l = max_err(o, o_ref), max_err(lse, lse_ref)
    if not (e_o <= 2e-2 and e_l <= 1e-5):
        fail("flash_attention_fwd disagrees with attention_ref at "
             "paligemma's training shape")
    del o, lse, o_ref, lse_ref
    ms = graph_ms(lambda: flash_attention_fwd(q, k, v, prefix=pre))
    plain_ms = graph_ms(lambda: attention_ref(q, k, v, prefix=pre), reps=3,
                        iters=3)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous()
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) | (pos[None, :] < pre)
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    pairs = prefix_causal_pairs(S, pre)
    el = q.element_size()
    nbytes = 2 * S * H * d * el + 2 * S * G * d * el + H * S * 4
    flops = 4 * H * d * pairs
    b = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
         "operations": flops / BF16_FLOPS * 1e3}
    by = max(b, key=b.get)
    print(f"[kernels] flash_attention_fwd at head dim 256, paligemma's "
          f"training shape q [1,{S},{H},{d}] kv [1,{S},{G},{d}] bf16 prefix="
          f"{pre} [flash_fwd_kernel_mma<256,4>: {cta_desc(256, 4)}]: max|d| "
          f"o={e_o:.3e} lse={e_l:.3e}; device time per call (CUDA graph): "
          f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms, SDPA (boolean prefix-LM mask) {lib_ms:.4f} ms"
          f" (kernel = {ms / lib_ms:.2f}x SDPA), bound {b[by] * 1e3:.2f} us "
          f"({by}; {pairs} visible pairs a head, {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB) = {ms / b[by]:.1f}x bound")
    del qt, kt, vt, mask
    from repro_torch.kernels.flash_attention import flash_attention
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    o = flash_attention(*leaves, prefix=pre)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(dt)
    bwd_ms = time_ms(lambda: torch.autograd.grad(o, leaves, do,
                                                 retain_graph=True),
                     iters=5, warmup=1)
    del o, leaves
    print(f"[kernels] the FlashAttention backward (plain VJP) at "
          f"paligemma's training shape: {bwd_ms:.3f} ms")
    rows["flash_attention_fwd"]["train_d256"] = {
        "max_abs_err": e_o, "lse_max_abs_err": e_l, "ms": ms,
        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b[by],
        "bound_by": by, "plain_bwd_ms": bwd_ms,
        "timed_shape": f"q [1,{S},{H},{d}] kv [1,{S},{G},{d}] bf16 "
                       f"prefix={pre}"}
    # the Function's gradients at D=256 with the prefix, both dtypes
    for gdt, tol_o, tol_g in ((torch.float32, 2e-5, 1e-5),
                              (torch.bfloat16, 2e-2, 1e-2)):
        _flash_grad_case(torch, gen, gdt, 512, tol_o, tol_g, H=8, G=1,
                         d=256, prefix=64)


def phase_flash_offsets(torch, gen, rows, H=32, G=4, d=64, n_seqs=(2, 4),
                        key="train_offsets"):
    """The flash kernel at the sequence-chunked training shapes: a query
    chunk of Sc = 2048 / n_seq rows at each offset q * Sc over the full
    2048-row K/V of one KV-carry slot (a view of a ring [2, 3, 1, 1,
    2048, G, d], contiguous and 16-byte aligned, as the executor's
    buffers are), bf16; tinyllama's heads (H 32, G 4, d 64) at n_seq = 2
    and 4, and deepseek-7b's (H = G = 32, d 128, phase 16's pick) at
    n_seq = 4.  Holds o and lse against
    ``attention_ref`` (phase 3's bf16 tolerances) and the
    ``FlashAttention`` Function's dq, dk, dv against autograd through
    ``attention_ref`` (``_flash_grad_case``'s tolerances), with dk and dv
    past the causal frontier exactly zero; times the kernel (CUDA
    graph), the plain version and SDPA given the equivalent boolean
    mask, beside the bound.  Adds ``rows["flash_attention_fwd"][key]``
    and the plain backward's ms by Sc under ``key + "_plain_bwd_ms"``."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention,
                                                     flash_attention_fwd)
    import torch.nn.functional as F
    S, dt = TRAIN_SEQ - 1, torch.bfloat16
    ring = {n: torch.randn((2, 3, 1, 1, S, G, d), generator=gen,
                           device="cuda").to(dt) for n in ("k", "v")}
    k, v = ring["k"][1, 2, 0], ring["v"][1, 2, 0]
    if not (k.is_contiguous() and k.data_ptr() % 16 == 0
            and v.data_ptr() % 16 == 0):
        fail("a KV-carry slot view is not contiguous and 16-byte aligned")
    kt = k.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous()
    out, bwd_ms = [], {}
    for ns in n_seqs:
        Sc = S // ns
        # the Function's plain backward (attention_ref over the whole
        # K/V, whatever the offset): the seq phases' profiles read it
        leaves = [a.clone().requires_grad_() for a in (
            torch.randn((1, Sc, H, d), generator=gen, device="cuda").to(dt),
            k, v)]
        o = flash_attention(*leaves, q_offset=Sc)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(dt)
        bwd_ms[Sc] = time_ms(lambda: torch.autograd.grad(
            o, leaves, do, retain_graph=True), iters=5, warmup=1)
        del o, leaves
        print(f"[kernels] the FlashAttention backward (plain VJP) at q "
              f"[1,{Sc},{H},{d}] over kv [1,{S},{G},{d}]: "
              f"{bwd_ms[Sc]:.3f} ms")
        for qi in range(ns):
            off = qi * Sc
            q = torch.randn((1, Sc, H, d), generator=gen,
                            device="cuda").to(dt)
            o, lse = flash_attention_fwd(q, k, v, q_offset=off)
            torch.cuda.synchronize()
            o_ref, lse_ref = attention_ref(q, k, v, q_offset=off)
            e_o, e_l = max_err(o, o_ref), max_err(lse, lse_ref)
            # the Function: kernel forward, dq/dk/dv over the whole K/V
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
            ins = [[a.clone().requires_grad_() for a in (q, k, v)]
                   for _ in range(2)]
            flash_attention(*ins[0], q_offset=off).backward(do)
            attention_ref(*ins[1], q_offset=off)[0].backward(do)
            e_g = [max_err(a.grad, b.grad) for a, b in zip(*ins)]
            past = max(float(a.grad[:, off + Sc:].abs().max())
                       if off + Sc < S else 0.0 for a in ins[0][1:])
            ok = e_o <= 2e-2 and e_l <= 1e-5 and max(e_g) <= 1e-2 \
                and past == 0.0
            del ins, o, lse, o_ref, lse_ref
            ms = graph_ms(lambda: flash_attention_fwd(q, k, v, q_offset=off))
            plain_ms = time_ms(lambda: attention_ref(q, k, v, q_offset=off),
                               iters=5, warmup=1)
            qt = q.transpose(1, 2).contiguous()
            mask = torch.arange(S, device="cuda")[None, :] <= (
                off + torch.arange(Sc, device="cuda")[:, None])
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            pairs = Sc * off + Sc * (Sc + 1) // 2     # causal, visible
            k_rows = off + Sc
            el = q.element_size()
            nbytes = 2 * Sc * H * d * el + 2 * k_rows * G * d * el \
                + H * Sc * 4
            flops = 4 * H * d * pairs
            b = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "operations": flops / BF16_FLOPS * 1e3}
            by = max(b, key=b.get)
            shape = (f"q [1,{Sc},{H},{d}] kv [1,{S},{G},{d}] bf16 "
                     f"q_offset={off} (n_seq={ns})")
            print(f"[kernels] flash_attention_fwd {shape}: max|d| o="
                  f"{e_o:.3e} (tol 0.02) lse={e_l:.3e} (tol 1e-05); "
                  f"FlashAttention dq={e_g[0]:.3e} dk={e_g[1]:.3e} dv="
                  f"{e_g[2]:.3e} (tol 0.01), max|dk, dv| past the frontier "
                  f"{past:g} (must be 0) {'ok' if ok else 'FAIL'}; "
                  f"kernel {ms * 1e3:.2f} us (CUDA graph), plain "
                  f"{plain_ms * 1e3:.2f} us, SDPA (boolean mask) "
                  f"{lib_ms * 1e3:.2f} us, bound {b[by] * 1e3:.2f} us "
                  f"({by}; {flops / 1e9:.2f} GFLOP) = {ms / b[by]:.1f}x "
                  f"bound")
            if not ok:
                fail(f"flash_attention_fwd / FlashAttention disagree with "
                     f"attention_ref at {shape}")
            out.append({"timed_shape": shape, "max_abs_err": e_o,
                        "lse_max_abs_err": e_l, "grad_max_abs_err": max(e_g),
                        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": b[by], "bound_by": by})
    rows["flash_attention_fwd"][key] = out
    rows["flash_attention_fwd"][key + "_plain_bwd_ms"] = bwd_ms


def phase_deepseek_rmsnorm(torch, gen, rows):
    """rmsnorm at phase 16's deepseek-7b chunk shape, x [512, 4096] bf16
    (a 512-position sequence chunk), held against its plain version with
    phase 3's tolerance and timed beside ``F.rms_norm`` and the bound."""
    from repro_torch.kernels.rmsnorm import rmsnorm_rows, rmsnorm_rows_ref
    R, D, dt = (TRAIN_SEQ - 1) // 4, 4096, torch.bfloat16
    x = torch.randn((R, D), generator=gen, device="cuda").to(dt)
    scale = (1 + 0.1 * torch.randn((D,), generator=gen,
                                   device="cuda")).to(dt)
    got = rmsnorm_rows(x, scale)
    torch.cuda.synchronize()
    want = rmsnorm_rows_ref(x, scale)
    e_r = max_err(got, want)
    ok = rel_ok(got, want, 1e-6, 2.0 ** -7)
    t = rmsnorm_times(torch, x, scale)
    nbytes = (2 * R * D + D) * x.element_size()
    rb = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
          "operations": 4 * R * D / FP32_FLOPS * 1e3}
    rby = max(rb, key=rb.get)
    print(f"[kernels] rmsnorm_rows bf16 x [{R},{D}] (deepseek-7b's chunk): "
          f"max|d|={e_r:.3e} tol=1e-06+0.0078125*|ref| "
          f"{'ok' if ok else 'FAIL'}; {rmsnorm_line(t)}; bound "
          f"{rb[rby] * 1e3:.3f} us ({rby})")
    if not ok:
        fail("rmsnorm_rows disagrees with its plain version at deepseek-7b's "
             "chunk shape")
    rows["rmsnorm_rows"]["train_planner_deepseek"] = {
        "max_abs_err": e_r, **t, "bound_ms": rb[rby], "bound_by": rby,
        "timed_shape": f"x [{R},{D}] bf16"}


# ---------------------------------------------------------------------------
# mamba2 slice: the SSD chunk scan
# ---------------------------------------------------------------------------

SSD_TOL = 1e-4          # y and h: max|d| <= SSD_TOL * max(1, max|ref|)


def _ssd_inputs(torch, gen, B, S, H, P, N, dtype):
    """Random SSD inputs on the card, of the sizes the model feeds the
    scan: x, B, C in ``dtype``; dt = softplus(N(0,1) - 2) and A = -exp(
    U(-0.5, 0.5)) in fp32, as the block derives them from its
    projections."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = rn(B, S, H, P).to(dtype)
    Bc = (0.5 * rn(B, S, N)).to(dtype)
    Cc = (0.5 * rn(B, S, N)).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H) - 2.0)
    A = -torch.exp(torch.rand((H,), generator=gen, device="cuda") - 0.5)
    return x, Bc, Cc, dt, A


def _ssd_bounds(B, S, H, P, N, Q, el):
    """(bytes, operations) the scan must move and do: x, B, C, dt and A
    read once, y and h written once in fp32; C B^T on and below the
    diagonal once per (batch, chunk) (every head shares it), and per
    (batch, head, chunk) the decay mask (4 operations per pair on and
    below the diagonal), the masked product with x, C h^T, the state
    update and the elementwise scales."""
    nc = S // Q
    tri = Q * (Q + 1) // 2
    nbytes = (B * S * H * P * el + 2 * B * S * N * el + B * S * H * 4
              + H * 4 + B * S * H * P * 4 + B * H * P * N * 4)
    ops = B * nc * 2 * N * tri + B * H * nc * (
        (4 + 2 * P) * tri + 4 * Q * N * P + 2 * Q * P + 2 * P * N)
    return nbytes, ops


def _ssd_design_bytes(B, S, H, P, N, Q, el):
    """(device-memory bytes, L2 re-reads) of the bf16 route's three
    passes, if nothing stayed in the L2 between them: what the call must
    move plus the state scratch [B, S/Q, H, P, N] fp32 (written by pass a,
    read and written by pass b, read by pass c) and cum; and, apart, the
    chunk's B (pass a) and B and C (pass c) tiles that every head and
    64-column block re-reads, which the L2 serves."""
    nc, npb = S // Q, -(-P // 64)
    must, _ = _ssd_bounds(B, S, H, P, N, Q, el)
    states = B * nc * H * P * N * 4
    cum = B * nc * H * Q * 4
    rereads = 3 * B * nc * H * npb * Q * N * el + 2 * npb * B * S * H * 4
    return must + 4 * states + 2 * cum, rereads


def _ssd_kernel_ms(torch, fn, calls: int = 1) -> dict:
    """Kernel name -> device ms per call of each SSD kernel that ``fn``
    launches, from ``torch.profiler`` over ``calls`` calls after one more
    untraced; the names tell the routes apart (``ROUTE_KERNELS``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"\bssd_scan_kernel\w*", e.key)
        if m:
            dev = getattr(e, "self_device_time_total", None)
            if dev is None:
                dev = getattr(e, "self_cuda_time_total", 0.0)
            out[m.group(0)] = out.get(m.group(0), 0.0) + dev / 1e3 / calls
    return out


def _ssd_route_of(names) -> str:
    """The route whose kernels are exactly ``names``, else 'none'."""
    from repro_torch.kernels.ssd_scan.ops import ROUTE_KERNELS
    return next((r for r, ks in ROUTE_KERNELS.items()
                 if set(names) == set(ks)), "none")


def phase_ssd(torch, gen):
    """``ssd_scan`` against ``ssd_chunked_ref`` on the card at (a) the
    reduced config's shape with S=17 (padded through ``ssd``), (b) S=256,
    Q=64, H=4, P=32, N=16, batch 2, (c) mamba2-2.7b's training shape x
    [1,2048,80,64], B and C [1,2048,128], Q=128, (d) P, N and Q off the
    16-multiples (P=24, N=40, Q=48), (e) P above one 64-column block and
    N at its limit (P=80, N=256, Q=64), in bf16 and fp32; each case
    prints the route whose kernels the profiler saw it run (bf16: the
    tensor-core passes, fp32: the CUDA-core kernel) and fails on any
    other.  Then timed at (c) in bf16 beside the plain version and the
    CUDA-core route on the same inputs in fp32."""
    from repro_torch.kernels.ssd_scan import (SSDScan, ssd, ssd_chunked_ref,
                                              ssd_scan, ssd_scan_route)
    cases = [("a", 2, 17, 8, 32, 16, 16), ("b", 2, 256, 4, 32, 16, 64),
             ("c", 1, TRAIN_SEQ - 1, 80, 64, 128, 128),
             ("d", 2, 96, 3, 24, 40, 48), ("e", 1, 128, 2, 80, 256, 64)]
    worst, worst_rel = 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        want = ssd_scan_route(dtype)
        for name, B, S, H, P, N, Q in cases:
            ins = _ssd_inputs(torch, gen, B, S, H, P, N, dtype)
            if S % Q:
                def call():
                    return ssd(*ins, chunk=Q)          # pads, then the kernel
            else:
                def call():
                    return ssd_scan(*ins, chunk=Q)
            before = ssd_scan.launches
            y, h = call()
            torch.cuda.synchronize()
            if ssd_scan.launches != before + 1:
                fail(f"ssd_scan ({name}, {dtype}) counted "
                     f"{ssd_scan.launches - before} launches, not 1")
            ran = _ssd_route_of(_ssd_kernel_ms(torch, call))
            y_ref, h_ref = ssd_chunked_ref(*ins, Q)
            scale = max(1.0, float(y_ref.abs().max()),
                        float(h_ref.abs().max()))
            e_y, e_h = max_err(y, y_ref), max_err(h, h_ref)
            ok = (y.shape == y_ref.shape and h.shape == h_ref.shape
                  and max(e_y, e_h) <= SSD_TOL * scale)
            print(f"[kernels] ssd_scan ({name}) {str(dtype)[6:]} x [{B},{S},"
                  f"{H},{P}] N={N} Q={Q}, route {ran}: "
                  f"max|d| y={e_y:.3e} h={e_h:.3e} "
                  f"(tol {SSD_TOL:g} * {scale:.3g}) "
                  f"{'ok' if ok else 'FAIL'}")
            if ran != want:
                fail(f"ssd_scan ({name}, {dtype}) ran {ran}, not {want}")
            if not ok:
                fail(f"ssd_scan disagrees with ssd_chunked_ref ({name}, "
                     f"{dtype})")
            worst = max(worst, e_y, e_h)
            worst_rel = max(worst_rel, e_y / scale, e_h / scale)
    # main-path shape: one mamba2-2.7b layer's scan in training, bf16
    B, S, H, P, N, Q = 1, TRAIN_SEQ - 1, 80, 64, 128, 128
    ins = _ssd_inputs(torch, gen, B, S, H, P, N, torch.bfloat16)
    wide = [t.float() for t in ins]
    ms = time_ms(lambda: ssd_scan(*ins, chunk=Q), iters=50, warmup=5)
    was_ms = time_ms(lambda: ssd_scan(*wide, chunk=Q), iters=10, warmup=2)
    plain_ms = time_ms(lambda: ssd_chunked_ref(*ins, Q), iters=5, warmup=1)
    passes = _ssd_kernel_ms(torch, lambda: ssd_scan(*ins, chunk=Q), calls=10)
    del wide
    leaves = [t.clone().requires_grad_() for t in ins]
    y, h = SSDScan.apply(*leaves, None, Q)
    dy = torch.randn(y.shape, generator=gen, device="cuda")
    bwd_ms = time_ms(lambda: torch.autograd.grad(y, leaves, dy,
                                                 retain_graph=True),
                     iters=5, warmup=1)
    del y, h, leaves
    nbytes, ops = _ssd_bounds(B, S, H, P, N, Q, 2)
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": ops / BF16_FLOPS * 1e3}
    bound_by = max(bounds, key=bounds.get)
    dram, rereads = _ssd_design_bytes(B, S, H, P, N, Q, 2)
    route = ssd_scan_route(torch.bfloat16)
    print(f"[kernels] ssd_scan timed at x [{B},{S},{H},{P}] bf16, N={N}, "
          f"Q={Q} (CUDA events), route {route}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, the CUDA-core route on the same inputs "
          f"widened to fp32 {was_ms:.3f} ms, bound "
          f"{bounds[bound_by] * 1e3:.2f} us ({bound_by}; "
          f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) = "
          f"{ms / bounds[bound_by]:.1f}x bound; no one-call PyTorch "
          f"yardstick; the SSDScan backward (plain VJP, recomputing "
          f"ssd_chunked_ref) {bwd_ms:.3f} ms")
    print(f"[kernels] ssd_scan design traffic (three passes, a model of "
          f"the shapes, not a measurement): {dram / 1e6:.1f} MB of device "
          f"memory if nothing stays in the L2 "
          f"({dram / HBM_BYTES_PER_S * 1e6:.2f} us at 3.35 TB/s; the "
          f"{nbytes / 1e6:.1f} MB the call must "
          f"move plus the fp32 state scratch, written, read and written, "
          f"read), and {rereads / 1e6:.1f} MB of B, C and dt re-read per "
          f"head from the L2")
    print(f"[kernels] ssd_scan passes (torch.profiler, device ms per call): "
          + (", ".join(f"{k} {v:.4f}" for k, v in passes.items())
             or "not measured (no device time reported)"))
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:60",
            "max_abs_err": worst,
            "max_err_over_scale": worst_rel,     # scale: max(1, max|ref|)
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[bound_by],
            "bound_by": bound_by, "library_ms": None,
            "kernel_route": route, "was_ms": was_ms, "pass_ms": passes,
            "plain_bwd_ms": bwd_ms,
            "timed_shape": f"x [{B},{S},{H},{P}] B,C [{B},{S},{N}] bf16, "
                           f"Q={Q}"}


def phase_ssd_h0(torch, gen, rows):
    """``ssd_scan`` with a carried state ``h0`` at mamba2-2.7b's serving
    prefill shape (x [1,128,80,64], B and C [1,128,128], Q=128, h0
    [1,80,64,128] fp32), on the bf16 tensor-core route and the fp32
    CUDA-core route: against ``ssd_chunked_ref(h0=)`` at phase 3's
    tolerance, an h0 of zeros bitwise the launch without h0 (y and h),
    then timed in bf16 beside the plain version and the bound (the call
    must also read h0)."""
    from repro_torch.kernels.ssd_scan import (ssd_chunked_ref, ssd_scan,
                                              ssd_scan_route)
    B, S, H, P, N, Q = 1, 128, 80, 64, 128, 128
    h0 = 0.5 * torch.randn((B, H, P, N), generator=gen, device="cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        ins = _ssd_inputs(torch, gen, B, S, H, P, N, dtype)
        y, h = ssd_scan(*ins, chunk=Q, h0=h0)
        torch.cuda.synchronize()
        ran = _ssd_route_of(_ssd_kernel_ms(
            torch, lambda: ssd_scan(*ins, chunk=Q, h0=h0)))
        y_ref, h_ref = ssd_chunked_ref(*ins, Q, h0)
        scale = max(1.0, float(y_ref.abs().max()), float(h_ref.abs().max()))
        e_y, e_h = max_err(y, y_ref), max_err(h, h_ref)
        z = ssd_scan(*ins, chunk=Q, h0=torch.zeros_like(h0))
        n = ssd_scan(*ins, chunk=Q)
        bitwise = torch.equal(z[0], n[0]) and torch.equal(z[1], n[1])
        ok = max(e_y, e_h) <= SSD_TOL * scale
        print(f"[kernels] ssd_scan h0 {str(dtype)[6:]} x [{B},{S},{H},{P}] "
              f"N={N} Q={Q}, route {ran}: max|d| vs ssd_chunked_ref(h0) "
              f"y={e_y:.3e} h={e_h:.3e} (tol {SSD_TOL:g} * {scale:.3g}) "
              f"{'ok' if ok else 'FAIL'}; h0=zeros "
              f"{'bitwise ==' if bitwise else 'DIFFERS from'} no h0")
        if ran != ssd_scan_route(dtype):
            fail(f"ssd_scan h0 ({dtype}) ran {ran}")
        if not ok:
            fail(f"ssd_scan with h0 disagrees with its plain version "
                 f"({dtype})")
        if not bitwise:
            fail(f"ssd_scan with h0 = 0 is not bitwise the launch without "
                 f"h0 ({dtype})")
        out[str(dtype)[6:]] = {"max_abs_err": max(e_y, e_h),
                               "route": ran, "zeros_bitwise": bitwise}
    # device time per call from CUDA-graph replay (each call is three
    # short pass kernels, so call-to-call eager time is the host's)
    ms = graph_ms(lambda: ssd_scan(*ins, chunk=Q, h0=h0))
    ms0 = graph_ms(lambda: ssd_scan(*ins, chunk=Q))
    eager_ms = time_ms(lambda: ssd_scan(*ins, chunk=Q, h0=h0), iters=100,
                       warmup=10)
    passes = _ssd_kernel_ms(torch, lambda: ssd_scan(*ins, chunk=Q, h0=h0),
                            calls=10)
    plain_ms = time_ms(lambda: ssd_chunked_ref(*ins, Q, h0), iters=20,
                       warmup=2)
    nbytes, ops = _ssd_bounds(B, S, H, P, N, Q, 2)
    nbytes += B * H * P * N * 4                           # h0 read once
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": ops / BF16_FLOPS * 1e3}
    by = max(bounds, key=bounds.get)
    print(f"[kernels] ssd_scan h0 timed at x [{B},{S},{H},{P}] bf16 "
          f"(device time per call, CUDA graph): kernel {ms * 1e3:.2f} us "
          f"with h0, {ms0 * 1e3:.2f} us without (eager call-to-call "
          f"{eager_ms * 1e3:.2f} us), plain {plain_ms:.3f} ms (CUDA "
          f"events), bound "
          f"{bounds[by] * 1e3:.2f} us ({by}; {nbytes / 1e6:.2f} MB, "
          f"{ops / 1e9:.3f} GFLOP) = {ms / bounds[by]:.1f}x bound; passes "
          f"(torch.profiler, device us per call): "
          + (", ".join(f"{k} {v * 1e3:.2f}" for k, v in passes.items())
             or "not measured (no device time reported)"))
    rows["ssd_scan"]["serve_h0"] = {
        **out, "shape": f"x [{B},{S},{H},{P}] bf16, h0 [{B},{H},{P},{N}] "
        f"fp32, Q={Q}", "ms": ms, "ms_without_h0": ms0,
        "eager_ms": eager_ms, "pass_ms": passes,
        "plain_ms": plain_ms, "bound_ms": bounds[by], "bound_by": by}


def phase_ssd_grads(torch, gen):
    """Gradients through ``SSDScan`` (kernel forward, plain backward)
    equal autograd through ``ssd_chunked_ref`` bitwise, fp32 and bf16, at
    shape (b) and at the training shape; the output carries a grad_fn."""
    from repro_torch.kernels.ssd_scan import SSDScan, ssd_chunked_ref
    for dtype, (B, S, H, P, N, Q) in (
            (torch.float32, (2, 256, 4, 32, 16, 64)),
            (torch.bfloat16, (2, 256, 4, 32, 16, 64)),
            (torch.float32, (1, TRAIN_SEQ - 1, 80, 64, 128, 128)),
            (torch.bfloat16, (1, TRAIN_SEQ - 1, 80, 64, 128, 128))):
        ins = _ssd_inputs(torch, gen, B, S, H, P, N, dtype)
        dy = torch.randn((B, S, H, P), generator=gen, device="cuda")
        dh = torch.randn((B, H, P, N), generator=gen, device="cuda")
        a = [t.clone().requires_grad_() for t in ins]
        b = [t.clone().requires_grad_() for t in ins]
        y1, h1 = SSDScan.apply(*a, None, Q)
        if y1.grad_fn is None or h1.grad_fn is None:
            fail("SSDScan output carries no grad_fn")
        g1 = torch.autograd.grad((y1, h1), a, (dy, dh))
        y2, h2 = ssd_chunked_ref(*b, Q)
        g2 = torch.autograd.grad((y2, h2), b, (dy, dh))
        same = all(torch.equal(u, v) for u, v in zip(g1, g2))
        errs = [max_err(u, v) for u, v in zip(g1, g2)]
        print(f"[kernels] SSDScan {str(dtype)[6:]} x [{B},{S},{H},{P}] "
              f"N={N} Q={Q}: gradients (x, B, C, dt, A) "
              f"{'bitwise equal' if same else 'DIFFER'} to autograd through "
              f"ssd_chunked_ref (max|d| {max(errs):.3e}, tol 0); forward "
              f"max|d| y={max_err(y1, y2):.3e}")
        if not same:
            fail("SSDScan gradients differ from the plain version's")


def phase_mamba_shapes(torch, gen, rows):
    """rmsnorm at mamba2-2.7b's training shapes (``norm1`` x [2048, 2560]
    and the gated norm [2048, 5120], bf16): held against its plain
    version and timed."""
    from repro_torch.kernels.rmsnorm import rmsnorm_rows, rmsnorm_rows_ref
    S, dt = TRAIN_SEQ - 1, torch.bfloat16
    out = {}
    for d in (2560, 5120):
        x = torch.randn((S, d), generator=gen, device="cuda").to(dt)
        scale = (1 + 0.1 * torch.randn((d,), generator=gen,
                                       device="cuda")).to(dt)
        got = rmsnorm_rows(x, scale)
        torch.cuda.synchronize()
        want = rmsnorm_rows_ref(x, scale)
        e = max_err(got, want)
        if not rel_ok(got, want, 1e-6, 2.0 ** -7):
            fail(f"rmsnorm_rows disagrees with its plain version at "
                 f"[{S}, {d}]")
        t = rmsnorm_times(torch, x, scale)
        rb = {"bytes": (2 * S * d + d) * 2 / HBM_BYTES_PER_S * 1e3,
              "operations": 4 * S * d / FP32_FLOPS * 1e3}
        rby = max(rb, key=rb.get)
        print(f"[kernels] rmsnorm_rows bf16 x [{S},{d}] (mamba2 training): "
              f"max|d|={e:.3e} (tol 1e-06+0.0078125*|ref|) ok; "
              f"{rmsnorm_line(t)}; bound {rb[rby] * 1e3:.3f} us ({rby})")
        out[f"x [{S},{d}] bf16"] = {
            "max_abs_err": e, **t, "bound_ms": rb[rby], "bound_by": rby}
    rows["rmsnorm_rows"]["train_mamba2"] = out


def _body_ops(spec):
    """(op, first, last) for every op of the task table that runs the
    chunk body: F, B and W ops, except a split backward of the first
    block, which computes nothing (its input gradient has no receiver);
    ``first``: the op embeds the microbatch (and runs an encoder-decoder
    config's encoder); ``last``: the op runs the head too."""
    from repro_torch.core.tasktable import B_OPS, IDLE, R_OPS
    tab, lay = spec.table, spec.layout
    for t in range(tab.T):
        for d in range(tab.P):
            op, c = int(tab.op[t, d]), int(tab.chunk[t, d])
            if op == IDLE or op in R_OPS:
                continue
            s = lay.pl.stage(d, c)
            first = c == 0 and s == 0
            if op in B_OPS and tab.has_w and first:
                continue
            yield op, first, c == tab.v - 1 and s == tab.P - 1


def _layers_of(spec, kind: str) -> int:
    """Layers of ``kind`` in one block (padding layers included)."""
    lay = spec.layout
    return lay.M * sum(spec.cfg.layer_kind(j) == kind
                       for j in range(lay.period))


def expected_train_launches(spec, n_leaves: int):
    """Kernel launches of one training step, derived from the task table:
    every op that runs the chunk body runs its K layers; an attention
    layer launches one flash kernel, a Mamba-2 layer one SSD scan, and
    each launches rmsnorm for ``norm1``, for the Mamba-2 block's gated
    norm, for ``norm_x`` before an encoder-decoder's cross-attention
    (which takes the plain path) and for ``norm2`` where the config has
    an FFN; the final norm runs where an op runs the head, and where an
    op embeds the microbatch of an encoder-decoder config the encoder
    runs (per layer one flash kernel, rmsnorm twice; then ``enc_norm``).  The table's rows are per device
    under its placement (the V-shape fold-back too) and per sequence
    chunk: a sequence-chunked F runs each layer's flash once at its
    chunk's offset, and its B once more in the replay.  The update
    launches fused AdamW once per leaf where the table has W tasks (the
    split backward: zero-bubble and V-shape), else not at all."""
    cfg = spec.cfg
    attn, mamba = _layers_of(spec, "attn"), _layers_of(spec, "mamba")
    rms = attn + 2 * mamba + (attn + mamba) * (cfg.d_ff > 0) \
        + (attn + mamba) * (cfg.encdec is not None)
    n_enc = cfg.encdec.num_encoder_layers if cfg.encdec is not None else 0
    n = {"flash_attention_fwd": 0, "rmsnorm_rows": 0, "ssd_scan": 0}
    for _, first, last in _body_ops(spec):
        n["flash_attention_fwd"] += attn + first * n_enc
        n["ssd_scan"] += mamba
        n["rmsnorm_rows"] += rms + last + first * (2 * n_enc + (n_enc > 0))
    return {**n, "fused_adamw_flat": n_leaves if spec.table.has_w else 0}


def plain_backward_calls(spec, kind: str) -> int:
    """Calls per step of the plain backward of the ``kind`` layers'
    kernel Function: once per layer in every B and W op that runs the
    chunk body under autograd (and per encoder layer where such an op
    runs the encoder)."""
    from repro_torch.core.tasktable import F_OPS
    cfg = spec.cfg
    n_enc = cfg.encdec.num_encoder_layers \
        if cfg.encdec is not None and kind == "attn" else 0
    return sum((_layers_of(spec, kind) + first * n_enc)
               for op, first, _ in _body_ops(spec) if op not in F_OPS)


def _train_config(arch: str, layers=None, seq=TRAIN_SEQ, **plan):
    """Phase 6's configuration of ``arch`` (cut to ``layers`` layers if
    given; ``seq`` tokens a sequence); ``plan`` overrides fields of its
    ``ParallelPlan`` (chronos_zb, v=2, 8 microbatches of one sequence,
    fused kernels)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import (OptimizerConfig, ParallelPlan,
                                          ShapeConfig, TrainConfig)
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return TrainConfig(
        model=cfg,
        shape=ShapeConfig("train_2k", seq_len=seq, global_batch=8,
                          kind="train"),
        plan=ParallelPlan(**{**dict(schedule="chronos_zb", num_chunks=2,
                                    microbatch_size=1, num_microbatches=8,
                                    kernels="fused"), **plan}),
        optimizer=OptimizerConfig(warmup_steps=2, total_steps=4),
        seed=0, log_every=1)


def _spec_of(tc, P: int):
    """The ``PipelineSpec`` that ``train_pipeline(tc, P=P)`` builds."""
    from repro_torch.core.pipeline_runtime import make_pipeline_spec
    from repro_torch.launch.steps import plan_schedule_kwargs
    plan = tc.plan
    m = plan.num_microbatches or max(
        2, tc.shape.global_batch // plan.microbatch_size)
    return make_pipeline_spec(
        tc.model, P=P, v=plan.num_chunks, m=m,
        microbatch=plan.microbatch_size, seq_len=tc.shape.seq_len,
        schedule=plan.schedule, kernels=plan.kernels, n_seq=plan.seq_chunks,
        **plan_schedule_kwargs(plan))


def _kernel_fns():
    """name -> the wrapper whose ``launches`` counts that kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fused_adamw import fused_adamw_flat
    from repro_torch.kernels.rmsnorm import rmsnorm_rows
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"rmsnorm_rows": rmsnorm_rows,
            "flash_attention_fwd": flash_attention_fwd,
            "fused_adamw_flat": fused_adamw_flat, "ssd_scan": ssd_scan}


def phase_train(torch, arch: str, tag: str, bwd_ms, P=4, layers=None,
                inspect=None, seq=TRAIN_SEQ, **plan):
    """Full-width ``arch`` (cut to ``layers`` layers if given) trained 4
    steps on ``P`` virtual stages through ``train_pipeline``, with phase
    6's plan (chronos_zb) or ``plan``'s overrides of it (phases 12-14:
    v_min, chronos_seq, seq1f1b); launch counts from the table; then one
    more step under the profiler.  ``bwd_ms``: layer kind -> the per-call
    time of its kernel Function's plain backward at the training shape
    (phase 3), or None where phase 3 did not time this model's shape.
    ``inspect(tc, spec, out)`` runs on the trained state before it is
    freed.  Returns the launch counts, losses, peak memory and median
    step (phase 11 holds its offload runs against them)."""
    from repro_torch.core.pipeline_runtime import init_pipeline_params
    from repro_torch.launch.train import train_pipeline
    from repro_torch.tree import tree_leaves
    tc = _train_config(arch, layers=layers, seq=seq, **plan)
    steps = 4
    spec = _spec_of(tc, P)
    tab = spec.table
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(tc.seed)
    params = init_pipeline_params(gen, tc.model, spec.layout, "cuda")
    leaves = tree_leaves(params)
    n_params = sum(a.numel() for a in leaves)
    before = [a.flatten()[:4096].to(torch.float32, copy=True)
              for a in leaves]
    lay = spec.layout
    print(f"[{tag}] {tc.model.name} full width bf16, {tab.name} "
          f"({lay.pl.name} placement) P={P} v={lay.v} m={tab.m} n_seq="
          f"{tab.n_seq} mbB={spec.mbB} seq {spec.S}: L_pad={lay.L_pad} "
          f"K={lay.K}, {n_params / 1e9:.3f} B parameters in {len(leaves)} "
          f"leaves; table T={tab.T} act {tab.act_depth} kv {tab.kv_depth} "
          f"wstash {tab.wstash_depth} rmt {tab.rmt_depth} fq "
          f"{tab.fq_depth} bq {tab.bq_depth}")
    kernels = _kernel_fns()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    out = train_pipeline(tc, P=P, device="cuda", steps=steps, params=params,
                         log=lambda s: print(s, flush=True))
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    per_step = expected_train_launches(spec, len(leaves))
    want = {k: steps * n for k, n in per_step.items()}
    tokens = spec.table.m * spec.mbB * spec.S
    med = statistics.median(out["step_s"][1:])      # step 1 warms up
    print(f"[{tag}] steps={out['steps']} losses={out['losses']} "
          f"grad_norms={out['grad_norms']} lrs={out['lrs']} "
          f"step_s={out['step_s']}")
    print(f"[{tag}] median step {med * 1e3:.1f} ms (steps 2-4: "
          f"{[round(s * 1e3, 1) for s in out['step_s'][1:]]}), "
          f"{tokens} tokens/step -> {tokens / med:.1f} tokens/s; "
          f"max_memory_allocated={peak / 2 ** 30:.3f} GiB")
    print(f"[{tag}] launches {launches} (per step from the table: "
          f"{per_step})")
    if launches != want:
        fail(f"{arch} training kernel launches {launches} != expected {want}")
    if not all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]):
        fail(f"{arch}: non-finite loss or grad_norm")
    # every fp32 master leaf moved; a bf16 weight may round back to its
    # old value (a norm scale of 1.0 moved by lr ~ 3e-4 is 1.0 in bf16)
    masters = tree_leaves(out["opt_state"]["master"])
    unchanged = [i for i, (a, b) in enumerate(zip(before, masters))
                 if torch.equal(a, b.flatten()[:4096])]
    moved_w = sum(not torch.equal(a, b.flatten()[:4096].float())
                  for a, b in zip(before, tree_leaves(out["params"])))
    print(f"[{tag}] weights moved: {len(masters) - len(unchanged)} of "
          f"{len(masters)} fp32 master leaves, {moved_w} of "
          f"{len(masters)} weight leaves (first 4096 elements of each)")
    if unchanged:
        fail(f"{arch}: master weight leaves {unchanged} did not change")
    # the plain backward's per-call time at this table's chunk length
    Sc = spec.S // spec.n_seq
    bwd = [(kind, bwd_ms[kind] if spec.n_seq == 1 else bwd_ms[kind, Sc],
            plain_backward_calls(spec, kind))
           for kind in ("attn", "mamba")
           if _layers_of(spec, kind) and bwd_ms is not None]
    ssd_counts = profile_train_step(torch, tc, P, out["params"],
                                    out["opt_state"], med, tag, bwd)
    if per_step["ssd_scan"]:
        # the device ran the tensor-core passes, once each per scan
        from repro_torch.kernels.ssd_scan.ops import ROUTE_KERNELS
        want_ssd = {k: per_step["ssd_scan"]
                    for k in ROUTE_KERNELS["tensor_cores"]}
        print(f"[{tag}] ssd_scan kernels in the profiled step: {ssd_counts}")
        if ssd_counts != want_ssd:
            fail(f"{arch}: the profiled step ran SSD kernels {ssd_counts}, "
                 f"not the tensor-core route's {want_ssd}")
    summary = {"losses": out["losses"], "peak": peak, "median_s": med,
               "launches": launches, "per_step": per_step,
               "schedule": tab.name, "tokens_per_s": tokens / med,
               "layers": tc.model.num_layers}
    if inspect is not None:
        summary.update(inspect(tc, spec, out))
    TRAIN_RUNS.append((tag, tc, P, peak))
    del out, params
    torch.cuda.empty_cache()
    return summary


def moe_router_stats(torch, tc, spec, out):
    """Every MoE layer's ``lb_loss`` and dropped fraction under the
    trained weights, on one fresh training sequence: one more forward
    through ``LM.loss`` (the blocks unstaged, a copy) under ``no_grad``
    with ``moe_ffn``'s aux recorded.  Fails on a non-finite value."""
    from repro_torch.core.pipeline_runtime import unstage_params
    from repro_torch.models import LM
    from repro_torch.models import moe as MOE
    lm_params = unstage_params(out["params"], spec.layout)
    tokens = _profile_batch(torch, tc, 1, 1)["tokens"][0]
    rec, orig = [], MOE.moe_ffn

    def recording(*a, **k):
        y, aux = orig(*a, **k)
        rec.append(aux)
        return y, aux
    MOE.moe_ffn = recording
    try:
        with torch.no_grad():
            loss, parts = LM(tc.model, device="cuda").loss(
                lm_params, {"tokens": tokens})
    finally:
        MOE.moe_ffn = orig
    lb = [float(a["lb_loss"]) for a in rec]
    dropped = [float(a["router_fraction_dropped"]) for a in rec]
    print(f"[train-moe] trained weights, one {tokens.shape[1]}-token "
          f"sequence: loss {float(loss):.4f} = ce {float(parts['ce']):.4f} "
          f"+ 0.01 x aux {float(parts['aux']):.4f}; per MoE layer lb_loss "
          f"{[round(x, 4) for x in lb]}, dropped fraction "
          f"{[round(x, 4) for x in dropped]}")
    if not all(math.isfinite(x) for x in lb + dropped + [float(loss)]):
        fail("non-finite MoE router statistics")
    del lm_params
    return {"lb_loss": lb, "dropped": dropped}


def _moe_ffn_plain(torch, p, x, cfg, act: str):
    """An independent plain MoE FFN for the card check: ``torch.topk``
    routing and a loop over the experts, each taking the tokens that
    picked it in token order up to its capacity and adding its gated
    output to them, then the shared experts.  x [T, d]; returns (y,
    lb_loss, dropped fraction as a host float)."""
    import torch.nn.functional as F
    T = x.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    if act != "silu":
        raise ValueError(f"_moe_ffn_plain covers silu experts, not {act}")
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    vals, idx = torch.topk(probs, K, dim=-1)
    gates = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    cap = int(max(1, -(-T * K // E) * cfg.capacity_factor))
    cap = -(-cap // (128 if cap >= 128 else 16)) * (128 if cap >= 128 else 16)
    y = torch.zeros_like(x)
    counts = torch.zeros(E, device=x.device)
    kept = 0
    for e in range(E):
        hit = idx == e                                       # [T, K]
        toks = hit.any(1).nonzero().squeeze(1)               # ascending
        counts[e] = toks.numel()
        toks = toks[:cap]
        kept += toks.numel()
        g = (gates * hit).sum(1)[toks]
        xe = x[toks]
        h = F.silu(xe @ p["wg"][e]) * (xe @ p["wi"][e])
        y = y.index_add(0, toks, g[:, None] * (h @ p["wo"][e]))
    sh = p["shared"]
    y = y + (F.silu(x @ sh["wg"]) * (x @ sh["wi"])) @ sh["wo"]
    lb = E * (probs.mean(0) * counts / T).sum()
    return y, lb, 1.0 - kept / (T * K)


def phase_moe_checks(torch, tag: str):
    """qwen2-moe-a2.7b's MoE path on the card, fp32 at full width.  (a)
    One layer's ``moe_ffn`` at T = 2048 (phase 15a's sequence) against
    :func:`_moe_ffn_plain` on the same weights: inputs x = z + 0.5 u
    (z per token, u shared by all, both N(0, 1)) skew the routing so
    that the capacity of 256 drops tokens; y and the gradients of
    sum(y dy) + lb_loss for x and every leaf within 2e-5 relative,
    lb_loss within 1e-6, the dropped fraction equal and above 0, and the
    port's picks the same expert sets as ``torch.topk``'s.  (b) Pipeline
    loss and gradients against ``LM.loss`` autograd, 4 layers, P=2, v=2,
    m=4, seq 257, chronos_zb and chronos, with the capacity factor at 0.5
    (16 slots per expert for 1024 picks: every layer drops), each within
    2e-5 relative (phase 15's measure).  Both sides run the plain
    kernels, so they route every token alike (a last-bit difference in
    the hidden state could flip a near-tie pick); the kernels are held
    in phases 3 and 5b."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                                   make_pipeline_spec,
                                                   make_train_grads_fn,
                                                   unstage_params)
    from repro_torch.models import LM
    from repro_torch.models import moe as MOE
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("qwen2-moe-a2.7b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (a)
    T, d = TRAIN_SEQ - 1, cfg.d_model
    p0 = MOE.init_moe(gen, 1, d, cfg.moe, cfg.act, torch.float32, "cuda")
    ps = [tree_map(lambda a: a[0].clone().requires_grad_(), p0)
          for _ in range(2)]
    del p0
    x = torch.randn((T, d), generator=gen, device="cuda") + 0.5 * torch.randn(
        (d,), generator=gen, device="cuda")
    dy = torch.randn((T, d), generator=gen, device="cuda")
    xs = [x.clone().requires_grad_() for _ in range(2)]
    y1, aux = MOE.moe_ffn(ps[0], xs[0][None], cfg.moe, cfg.act)
    y1 = y1[0]
    y2, lb2, drop2 = _moe_ffn_plain(torch, ps[1], xs[1], cfg.moe, cfg.act)
    _, _, gidx = MOE.route(x, ps[0]["router"].detach(), cfg.moe.top_k)
    picks = torch.equal(gidx.sort(1).values, torch.topk(
        torch.softmax(x @ ps[1]["router"].detach(), -1), cfg.moe.top_k,
        -1).indices.sort(1).values)
    ((y1 * dy).sum() + aux["lb_loss"]).backward()
    ((y2 * dy).sum() + lb2).backward()
    e_y = _rel_err(y1.detach(), y2.detach())
    lb1, lb2 = float(aux["lb_loss"].detach()), float(lb2.detach())
    e_lb = abs(lb1 - lb2)
    drop1 = float(aux["router_fraction_dropped"])
    e_g = max([_rel_err(xs[0].grad, xs[1].grad)]
              + [_rel_err(a.grad, b.grad) for a, b in
                 zip(tree_leaves(ps[0]), tree_leaves(ps[1]))])
    ok = (picks and e_y <= 2e-5 and e_lb <= 1e-6 and drop1 == drop2
          and drop1 > 0 and e_g <= 2e-5)
    print(f"[{tag}] (a) moe_ffn fp32 full width, T={T}, capacity "
          f"{MOE.capacity(T, cfg.moe)}: picks {'==' if picks else '!='} "
          f"torch.topk's sets; y rel {e_y:.3e} (tol 2e-5), lb_loss "
          f"{lb1:.6f} vs {lb2:.6f} (|d| "
          f"{e_lb:.3e}, tol 1e-6), dropped {drop1:.6f} vs {drop2:.6f} "
          f"(equal and > 0), grads of x and {len(tree_leaves(ps[0]))} "
          f"leaves rel {e_g:.3e} (tol 2e-5) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("moe_ffn on the card disagrees with the plain MoE FFN")
    del ps, xs, x, dy, y1, y2, aux, lb2
    torch.cuda.empty_cache()
    # (b)
    cfg = dataclasses.replace(
        cfg, num_layers=4, param_dtype="float32", compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    P, v, m, mbB, seq = 2, 2, 4, 1, 257
    spec = {s: make_pipeline_spec(cfg, P=P, v=v, m=m, microbatch=mbB,
                                  seq_len=seq, schedule=s, kernels="plain")
            for s in ("chronos_zb", "chronos")}
    layout = spec["chronos_zb"].layout
    params = init_pipeline_params(gen, cfg, layout, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (m, mbB, seq), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    lp = tree_map(lambda a: a.detach().clone().requires_grad_(),
                  unstage_params(params, layout))
    rec, orig = [], MOE.moe_ffn

    def recording(*a, **k):
        y, aux = orig(*a, **k)
        rec.append(float(aux["router_fraction_dropped"]))
        return y, aux
    MOE.moe_ffn = recording
    try:
        ref_loss = sum(LM(cfg, kernels="plain", device="cuda").loss(
            lp, {"tokens": tokens[i]})[0] for i in range(m))
    finally:
        MOE.moe_ffn = orig
    ref_g = torch.autograd.grad(ref_loss, tree_leaves(lp))
    ref_l = float(ref_loss.detach()) / m
    del lp, ref_loss
    if not min(rec) > 0:
        fail(f"qwen2-moe (b): a layer dropped no token ({rec})")
    for schedule, sp in spec.items():
        g, met = make_train_grads_fn(sp, "cuda")(params, {"tokens": tokens})
        gu = tree_leaves(unstage_params(g, sp.layout))
        e_l = abs(float(met["loss"]) - ref_l) / abs(ref_l)
        e_g = max(_rel_err(a, b) for a, b in zip(gu, ref_g))
        ok = e_l <= 2e-5 and e_g <= 2e-5
        print(f"[{tag}] (b) {schedule} plain, fp32 full width 4 layers, "
              f"capacity factor 0.5 (dropped per layer and microbatch "
              f"{min(rec):.4f}-{max(rec):.4f}): loss "
              f"{float(met['loss']):.6f} vs LM.loss {ref_l:.6f} (rel "
              f"{e_l:.3e}), grads rel {e_g:.3e} (tol 2e-5) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"qwen2-moe (b) {schedule} pipeline gradients disagree "
                 f"with LM.loss autograd")
        del g, gu
    del params, ref_g
    torch.cuda.empty_cache()


def _profile_batch(torch, tc, m, mbB):
    """A fresh batch of ``m`` microbatches of ``mbB`` sequences (with a
    VLM's patch or an encoder's frame embeddings)."""
    from repro_torch.data import synthetic_source
    flat = synthetic_source(tc.model, tc.shape.seq_len, seed=1
                            ).next_batch(m * mbB)
    if not isinstance(flat, dict):
        flat = {"tokens": flat}
    return {k: torch.from_numpy(a.reshape((m, mbB) + a.shape[1:]))
            .to("cuda") for k, a in flat.items()}


def profile_train_step(torch, tc, P, params, opt_state, untraced_s, tag,
                       bwd):
    """One more ``tc.plan.schedule`` step of the pipeline executor under
    the profiler (:func:`profile_step`)."""
    from repro_torch.launch.steps import make_pipeline_train_step
    step, m, mbB, _ = make_pipeline_train_step(tc.model, tc.shape, tc.plan,
                                               tc.optimizer, P=P,
                                               device="cuda")
    batch = _profile_batch(torch, tc, m, mbB)
    return profile_step(torch, lambda: step(params, opt_state, batch),
                        untraced_s, tag, bwd, f"one {tc.plan.schedule} step")


def profile_step(torch, run, untraced_s, tag, bwd, what):
    """``run()`` (one training step) under ``torch.profiler`` (device
    activity only: host ops of a mamba2 step number in the millions and
    take minutes to read): device busy share and the device time of our
    kernels, the matmuls and the rest.  ``bwd``: (layer kind, ms per call,
    calls per step) of the kernel Functions' plain backwards, whose share
    is their per-call time times their calls.  Returns SSD kernel name ->
    its launches in the step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    t_read = time.perf_counter()
    fams = {"fused_adamw_flat (ours)": 0.0, "rmsnorm_rows (ours)": 0.0,
            "flash_attention_fwd (ours)": 0.0, "ssd_scan (ours)": 0.0,
            "matmul": 0.0, "other": 0.0}
    rows, ssd_counts = [], {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue                  # runtime calls; their kernels count
        m = re.search(r"\bssd_scan_kernel\w*", e.key)
        if m:
            ssd_counts[m.group(0)] = ssd_counts.get(m.group(0), 0) + e.count
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev <= 0:
            continue
        rows.append((dev, e.count, e.key))
        name = e.key.lower()
        if "fused_adamw_kernel" in name:
            fams["fused_adamw_flat (ours)"] += dev
        elif "rmsnorm_rows_kernel" in name:
            fams["rmsnorm_rows (ours)"] += dev
        elif "flash_fwd_kernel" in name:
            fams["flash_attention_fwd (ours)"] += dev
        elif "ssd_scan_kernel" in name:
            fams["ssd_scan (ours)"] += dev
        elif any(t in name for t in ("gemm", "gemv", "xmma", "cutlass",
                                     "nvjet", "cublas")):
            fams["matmul"] += dev
        else:
            fams["other"] += dev
    busy = sum(fams.values())
    if busy <= 0:
        print(f"[profile-{tag}] the profiler reported no device time: "
              "device breakdown not measured")
        return ssd_counts
    print(f"[profile-{tag}] {what}: wall {wall_us / 1e3:.1f} "
          f"ms (profiled; {wall_us / 1e6 / untraced_s:.2f}x the untraced "
          f"median), device busy {busy / 1e3:.1f} ms = "
          f"{100 * busy / wall_us:.1f}% of wall, idle "
          f"{100 - 100 * busy / wall_us:.1f}%; untraced, the busy time is "
          f"{100 * busy / 1e6 / untraced_s:.1f}% of the median step (trace "
          f"read in {time.perf_counter() - t_read:.1f} s)")
    for fam, us in fams.items():
        print(f"[profile-{tag}]   {fam}: {us / 1e3:.2f} ms "
              f"({100 * us / busy:.1f}% of device time)")
    names = {"attn": "FlashAttention", "mamba": "SSDScan"}
    for kind, ms, calls in bwd:
        print(f"[profile-{tag}]   {names[kind]} plain backward: {calls} "
              f"calls x {ms:.3f} ms (per call, phase 3) = "
              f"{calls * ms:.1f} ms ({100 * calls * ms * 1e3 / busy:.1f}% of "
              f"device time; its kernels are inside matmul/other above)")
    for dev, count, key in sorted(rows, reverse=True)[:10]:
        print(f"[profile-{tag}]   top: {dev / 1e3:8.2f} ms x{count:<6d} "
              f"{key[:90]}")
    return ssd_counts


def phase_train_checks(torch, arch: str, tag: str):
    """``arch`` in fp32, full width, 4 layers, P=2, v=2, m=4, mbB=1, seq
    257 (for mamba2 two SSD chunks of 128): (a) pipeline loss and
    gradients (fused kernels) against LM.loss autograd (plain backend,
    same weights), chronos and chronos_zb; (b) chronos_recomp equals
    chronos bitwise; (c) fused against plain backend; (d) the kernel
    update equals the plain update bitwise."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                                   make_pipeline_spec,
                                                   make_train_grads_fn,
                                                   unstage_params)
    from repro_torch.models import LM
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(arch), num_layers=4,
                              param_dtype="float32", compute_dtype="float32")
    P, v, m, mbB, seq = 2, 2, 4, 1, 257

    def spec_of(schedule, kernels):
        return make_pipeline_spec(cfg, P=P, v=v, m=m, microbatch=mbB,
                                  seq_len=seq, schedule=schedule,
                                  kernels=kernels)

    base = spec_of("chronos", "fused")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_pipeline_params(gen, cfg, base.layout, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (m, mbB, seq), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    batch = {"tokens": tokens}
    lm = LM(cfg, kernels="plain", device="cuda")
    lp = tree_map(lambda a: a.detach().clone().requires_grad_(),
                  unstage_params(params, base.layout))
    ref_loss = sum(lm.loss(lp, {"tokens": tokens[i]})[0] for i in range(m))
    ref_g = torch.autograd.grad(ref_loss, tree_leaves(lp))
    ref_l = float(ref_loss.detach()) / m
    del lp

    def diff(a, b):
        return max(max_err(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))

    grads = {}
    for schedule, kernels in (("chronos", "fused"), ("chronos_zb", "fused"),
                              ("chronos_recomp", "fused"),
                              ("chronos_zb", "plain")):
        spec = spec_of(schedule, kernels)
        g, met = make_train_grads_fn(spec, "cuda")(params, batch)
        grads[(schedule, kernels)] = g
        if schedule in ("chronos", "chronos_zb") and kernels == "fused":
            gu = tree_leaves(unstage_params(g, spec.layout))
            err = max([abs(float(met["loss"]) - ref_l)]
                      + [max_err(a, b) for a, b in zip(gu, ref_g)])
            print(f"[{tag}] (a) {schedule} fused, fp32 full width 4 "
                  f"layers: loss {float(met['loss']):.6f} vs LM.loss "
                  f"{ref_l:.6f}; max|d| loss and grads {err:.3e} (tol 5e-3)")
            if not err <= 5e-3:
                fail(f"{arch} (a) {schedule} pipeline gradients disagree "
                     f"with LM.loss autograd")
    e_b = diff(grads[("chronos_recomp", "fused")], grads[("chronos", "fused")])
    print(f"[{tag}] (b) chronos_recomp vs chronos: max|d| {e_b:.3e} "
          f"(tol 0)")
    if e_b != 0.0:
        fail(f"{arch} (b) chronos_recomp is not bitwise equal to chronos")
    e_c = diff(grads[("chronos_zb", "fused")], grads[("chronos_zb", "plain")])
    print(f"[{tag}] (c) chronos_zb fused vs plain backend: max|d| "
          f"{e_c:.3e} (tol 1e-4)")
    if not e_c <= 1e-4:
        fail(f"{arch} (c) fused and plain backends disagree on gradients")
    # (d) this step's gradients, then the kernel update and the plain
    # update from copies of them
    ocfg = OptimizerConfig(warmup_steps=2, total_steps=4)
    g = grads[("chronos_zb", "fused")]
    masters = []
    for use_kernel in (True, False):
        st = adamw_init(params)
        gg = tree_map(lambda a: a / m, g)
        masters.append(adamw_update(gg, st, ocfg, use_kernel=use_kernel)[0])
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(masters[0]),
                                                 tree_leaves(masters[1])))
    print(f"[{tag}] (d) chronos_zb step, fused-AdamW kernel vs plain "
          f"update: master weights {'bitwise equal' if same else 'DIFFER'} "
          f"(max|d| {diff(masters[0], masters[1]):.3e}, tol 0)")
    if not same:
        fail(f"{arch} (d) the kernel update and the plain update differ")


# ---------------------------------------------------------------------------
# single-device slice: train() under Chronos-Recomp
# ---------------------------------------------------------------------------

def _single_config(arch: str, rc, mbB: int):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (OptimizerConfig, ParallelPlan,
                                          ShapeConfig, TrainConfig)
    return TrainConfig(
        model=get_config(arch),
        shape=ShapeConfig("train_2k", seq_len=TRAIN_SEQ, global_batch=8,
                          kind="train"),
        plan=ParallelPlan(num_chunks=2, microbatch_size=mbB, recompute=rc,
                          kernels="fused"),
        optimizer=OptimizerConfig(warmup_steps=2, total_steps=4),
        seed=0, log_every=1)


def expected_single_launches(cfg, m: int):
    """Kernel launches of one ``train()`` step of ``m`` microbatches: every
    layer launches flash (attention) or the SSD scan (Mamba-2) once and
    rmsnorm for ``norm1``, the Mamba-2 gated norm and ``norm2`` where the
    config has an FFN; a layer of the periods under a checkpoint launches
    them again when its backward recomputes it (every recompute mode
    wraps every period, ``none`` selectively); remainder layers run
    once.  The final norm is the plain one of ``LM.head``, and the update
    is the plain AdamW: no fused-AdamW launch."""
    wrapped = cfg.num_layers // cfg.period * cfg.period
    n = {"flash_attention_fwd": 0, "rmsnorm_rows": 0, "ssd_scan": 0,
         "fused_adamw_flat": 0}
    for idx in range(cfg.num_layers):
        times = m * (2 if idx < wrapped else 1)
        kind = cfg.layer_kind(idx)
        n["flash_attention_fwd"] += times * (kind == "attn")
        n["ssd_scan"] += times * (kind == "mamba")
        n["rmsnorm_rows"] += times * (1 + (kind == "mamba")
                                      + (cfg.d_ff > 0))
    return n


def train_single_run(torch, arch: str, rc, mbB: int, tag: str,
                     steps: int = 4, profile: bool = False):
    """Full-width ``arch`` through ``repro_torch.launch.train.train`` with
    recompute ``rc``, ``steps`` steps from random weights (seed 0), the
    peak counted from a reset after the earlier tensors are freed; checks
    launches, finite losses and gradient norms and moved masters.  With
    ``profile``, one more step under the profiler.  Returns (summary,
    launches)."""
    from repro_torch.launch.train import train
    from repro_torch.models import LM
    from repro_torch.tree import tree_leaves
    tc = _single_config(arch, rc, mbB)
    cfg = tc.model
    m = tc.shape.global_batch // mbB
    gc.collect()
    torch.cuda.empty_cache()
    params = LM(cfg, kernels="fused", device="cuda").init(
        torch.Generator(device="cuda").manual_seed(tc.seed))
    leaves = tree_leaves(params)
    before = [a.flatten()[:4096].to(torch.float32, copy=True)
              for a in leaves]
    print(f"[{tag}] {cfg.name} full width bf16 through train(): "
          f"{rc}, num_chunks={tc.plan.num_chunks}, m={m} microbatches of "
          f"{mbB} x {TRAIN_SEQ - 1} positions, "
          f"{sum(a.numel() for a in leaves) / 1e9:.3f} B parameters")
    kernels = _kernel_fns()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    out = train(tc, device="cuda", steps=steps, params=params,
                log=lambda s: print(f"[{tag}] {s}", flush=True))
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    per_step = expected_single_launches(cfg, m)
    want = {k: steps * n for k, n in per_step.items()}
    tokens = m * mbB * (TRAIN_SEQ - 1)
    med = statistics.median(out["step_s"][1:])      # step 1 warms up
    print(f"[{tag}] losses={out['losses']} grad_norms={out['grad_norms']} "
          f"step_s={out['step_s']}")
    print(f"[{tag}] median step {med * 1e3:.1f} ms (steps 2-{steps}: "
          f"{[round(t * 1e3, 1) for t in out['step_s'][1:]]}), {tokens} "
          f"tokens/step -> {tokens / med:.1f} tokens/s; "
          f"max_memory_allocated={peak / 2 ** 30:.3f} GiB")
    print(f"[{tag}] launches {launches} (per step, derived: {per_step})")
    if launches != want:
        fail(f"{tag}: kernel launches {launches} != expected {want}")
    if not all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]):
        fail(f"{tag}: non-finite loss or grad_norm")
    masters = tree_leaves(out["opt_state"]["master"])
    unchanged = [i for i, (a, b) in enumerate(zip(before, masters))
                 if torch.equal(a, b.flatten()[:4096])]
    print(f"[{tag}] weights moved: {len(masters) - len(unchanged)} of "
          f"{len(masters)} fp32 master leaves (first 4096 elements)")
    if unchanged:
        fail(f"{tag}: master weight leaves {unchanged} did not change")
    if profile:
        from repro_torch.launch.steps import make_train_step
        step, _ = make_train_step(cfg, tc.plan, tc.optimizer, m,
                                  device="cuda")
        batch = _profile_batch(torch, tc, m, mbB)
        profile_step(torch, lambda: step(out["params"], out["opt_state"],
                                         batch),
                     med, tag, [], f"one train() step ({rc.mode})")
    summary = {"losses": out["losses"], "grad_norms": out["grad_norms"],
               "median_ms": med * 1e3, "tokens_per_s": tokens / med,
               "peak_gib": peak / 2 ** 30}
    del out, params, leaves, masters
    gc.collect()
    torch.cuda.empty_cache()
    return summary, launches


def phase_train_single(torch):
    """10. ``train()`` at full width: tinyllama-1.1b in the recompute
    modes none, chronos (the shallow chunk fully rematerialized) and full,
    microbatch 4 (m = 2), a profiled chronos step; mamba2-2.7b in chronos,
    microbatch 1 (m = 8).  Step-1 losses bitwise across the modes, their
    gradient norms to 1e-6, peaks ordered none > chronos > full.  Returns
    the launch counts per path."""
    from repro_torch.configs.base import RecomputeConfig
    modes = {"none": RecomputeConfig("none"),
             "chronos": RecomputeConfig("chronos", num_recomp_chunks=1,
                                        policy="full"),
             "full": RecomputeConfig("full")}
    runs, total = {}, {}
    for name, rc in modes.items():
        runs[name], n = train_single_run(
            torch, "tinyllama-1.1b", rc, 4, f"train-single-{name}",
            profile=name == "chronos")
        total = {k: total.get(k, 0) + v for k, v in n.items()}
    l1 = {k: r["losses"][0] for k, r in runs.items()}
    g1 = {k: r["grad_norms"][0] for k, r in runs.items()}
    rel = max(abs(g - g1["none"]) / abs(g1["none"]) for g in g1.values())
    print(f"[train-single] step-1 losses {l1}; grad norms {g1} (max rel "
          f"|d| {rel:.3e}, tol 1e-6; "
          f"{'bitwise' if len(set(g1.values())) == 1 else 'not bitwise'})")
    for name, r in runs.items():
        print(f"[train-single] {name}: median step {r['median_ms']:.1f} ms, "
              f"{r['tokens_per_s']:.1f} tokens/s, peak {r['peak_gib']:.3f} "
              f"GiB")
    peaks = [runs[k]["peak_gib"] for k in ("none", "chronos", "full")]
    print(f"[train-single] peak none - chronos {peaks[0] - peaks[1]:.3f} "
          f"GiB, none - full {peaks[0] - peaks[2]:.3f} GiB")
    if len(set(l1.values())) != 1:
        fail(f"train-single: step-1 losses differ across modes: {l1}")
    if not rel <= 1e-6:
        fail(f"train-single: step-1 gradient norms differ: {g1}")
    if not peaks[0] > peaks[1] > peaks[2]:
        fail(f"train-single: peaks {peaks} not ordered none > chronos > "
             "full")
    done("train-single tinyllama-1.1b")
    _, mamba = train_single_run(
        torch, "mamba2-2.7b", modes["chronos"], 1, "train-single-mamba2")
    done("train-single mamba2-2.7b")
    return {"train_single_tinyllama": total, "train_single_mamba2": mamba}


def phase_train_single_checks(torch):
    """fp32, full width, 4 layers, batch 2 of 257 tokens (for mamba2 two
    SSD chunks): ``LM.loss(recomp=, num_chunks=2)`` loss and gradients
    through the fused backend bitwise equal to ``LM.loss()`` without
    remat, for every recompute mode and policy."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RecomputeConfig
    from repro_torch.models import LM
    from repro_torch.tree import tree_leaves, tree_map
    modes = [RecomputeConfig("none"),
             RecomputeConfig("chronos", policy="full"),
             RecomputeConfig("chronos", policy="selective"),
             RecomputeConfig("uniform"), RecomputeConfig("full")]
    for arch in ("tinyllama-1.1b", "mamba2-2.7b"):
        cfg = dataclasses.replace(get_config(arch), num_layers=4,
                                  param_dtype="float32",
                                  compute_dtype="float32")
        lm = LM(cfg, kernels="fused", device="cuda")
        params = lm.init(torch.Generator(device="cuda").manual_seed(0))
        tokens = torch.randint(0, cfg.vocab_size, (2, 257), device="cuda",
                               generator=torch.Generator(device="cuda")
                               .manual_seed(1))

        def loss_grads(rc):
            p = tree_map(lambda a: a.detach().requires_grad_(), params)
            loss = lm.loss(p, {"tokens": tokens}, recomp=rc, num_chunks=2)[0]
            return loss.detach(), torch.autograd.grad(loss, tree_leaves(p))
        l0, g0 = loss_grads(None)
        for rc in modes:
            l1, g1 = loss_grads(rc)
            err = max([abs(float(l1 - l0))]
                      + [max_err(a, b) for a, b in zip(g1, g0)])
            same = torch.equal(l0, l1) and all(
                torch.equal(a, b) for a, b in zip(g0, g1))
            print(f"[train-single-check] {arch} fp32 4 layers, {rc.mode}/"
                  f"{rc.policy}: loss {float(l1):.6f}, remat vs no remat "
                  f"max|d| {err:.3e} ({'bitwise' if same else 'DIFFER'}, "
                  f"tol 0)")
            if not same:
                fail(f"{arch}: remat {rc} changes the loss or gradients")
        del params, lm, g0
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# offload slice: Chronos-Offload in pipeline training
# ---------------------------------------------------------------------------

def _host_memory() -> str:
    try:
        with open("/proc/meminfo") as f:
            return next(line.split(":", 1)[1].strip() for line in f
                        if line.startswith("MemTotal"))
    except (OSError, StopIteration):
        return "not read"


def train_offload_run(torch, arch: str, tag: str, base, steps: int):
    """Phase 6's (phase 8's) run of ``arch`` with the deep chunk's AdamW on
    the host: same weights (seed 0), data and plan plus
    ``OffloadConfig(enabled=True, num_offload_chunks=1)``, ``steps``
    steps, the peak counted from a reset after the earlier tensors are
    freed.  ``base``: that phase's summary.  Checks finite losses and
    gradient norms, every shallow master moved, each collect's deep
    weights equal to their host masters rounded to bf16 (one slab per
    leaf, bitwise), the step-1 loss bitwise equal to the base run's, the
    launch counts, and the peak's fall of at least 0.9 x the deep
    chunk's fp32 master, mu and nu.  Returns the launch counts."""
    import dataclasses

    from repro_torch.configs.base import OffloadConfig
    from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                                   make_pipeline_spec)
    from repro_torch.launch.steps import offload_kept
    from repro_torch.launch.train import train_pipeline
    from repro_torch.optim import offload as offload_mod
    from repro_torch.tree import tree_leaves
    tc0 = _train_config(arch, layers=base["layers"])
    tc = dataclasses.replace(tc0, plan=dataclasses.replace(
        tc0.plan, offload=OffloadConfig(enabled=True, num_offload_chunks=1)))
    P, plan = 4, tc.plan
    spec = make_pipeline_spec(
        tc.model, P=P, v=plan.num_chunks, m=plan.num_microbatches,
        microbatch=plan.microbatch_size, seq_len=tc.shape.seq_len,
        schedule=plan.schedule, kernels=plan.kernels)
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(tc.seed)
    params = init_pipeline_params(gen, tc.model, spec.layout, "cuda")
    kept, deep = offload_kept(params, plan)
    n_deep = sum(a.numel() for a in tree_leaves(deep))
    deep_state = 12 * n_deep                  # fp32 master, mu, nu
    before = [a.flatten()[:4096].to(torch.float32, copy=True)
              for a in tree_leaves(kept)]
    print(f"[{tag}] {tc.model.name} as phase {base['phase']}, plus "
          f"{plan.offload}: deep chunk [:, {plan.num_chunks - 1}:] of the "
          f"block leaves = {n_deep / 1e6:.1f} M parameters, fp32 master, mu "
          f"and nu {deep_state / 2 ** 30:.3f} GiB on the host; host "
          f"{os.cpu_count()} CPUs, MemTotal {_host_memory()}")
    slabs = []                                # (device slab, host want)
    collect = offload_mod.ChronosOffloadRunner.collect

    def checked_collect(self):
        out = collect(self)
        for w, mst in zip(tree_leaves(out), tree_leaves(self.opt.master)):
            want = torch.from_numpy(mst[0].reshape(-1)[:4096].copy())
            slabs.append((w[0].flatten()[:4096].clone(),
                          want.to(torch.bfloat16).to(w.dtype)))
        return out

    kernels = _kernel_fns()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    offload_mod.ChronosOffloadRunner.collect = checked_collect
    try:
        out = train_pipeline(tc, P=P, device="cuda", steps=steps,
                             params=params,
                             log=lambda s: print(f"[{tag}] {s}", flush=True))
    finally:
        offload_mod.ChronosOffloadRunner.collect = collect
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    rep = out["offload"]
    n_leaves = len(before)
    want = {k: steps * n for k, n in base["per_step"].items()}
    want["fused_adamw_flat"] = steps * n_leaves
    tokens = spec.table.m * spec.mbB * spec.S
    med = statistics.median(out["step_s"][1:])
    fall = base["peak"] - peak
    print(f"[{tag}] losses={out['losses']} grad_norms={out['grad_norms']} "
          f"step_s={out['step_s']}")
    print(f"[{tag}] median step {med * 1e3:.1f} ms (steps 2-{steps}: "
          f"{[round(t * 1e3, 1) for t in out['step_s'][1:]]}; phase "
          f"{base['phase']} {base['median_s'] * 1e3:.1f} ms), {tokens} "
          f"tokens/step -> {tokens / med:.1f} tokens/s; "
          f"max_memory_allocated={peak / 2 ** 30:.3f} GiB against phase "
          f"{base['phase']}'s {base['peak'] / 2 ** 30:.3f}: fall "
          f"{fall / 2 ** 30:.3f} GiB (need >= 0.9 x {deep_state / 2 ** 30:.3f}"
          f" = {0.9 * deep_state / 2 ** 30:.3f})")
    print(f"[{tag}] loss - phase {base['phase']} loss at steps 1-{steps}: "
          f"{[a - b for a, b in zip(out['losses'], base['losses'])]}")
    print(f"[{tag}] offload: collect_wait_s {rep['collect_wait_s']:.3f}, "
          f"overlapped/submits {rep['overlapped']}/{rep['submits']}, host "
          f"update s {[round(t, 3) for t in rep['host_update_s']]}, "
          f"copy-down {rep['bytes_down'] / 1e9:.3f} GB in ms "
          f"{[round(t, 2) for t in rep['copy_down_ms']]} (GB/s "
          f"{[round(g, 2) for g in rep['copy_down_gbps']]}), upload "
          f"{rep['bytes_up'] / 1e9:.3f} GB in ms "
          f"{[round(t, 2) for t in rep['upload_ms']]} (GB/s "
          f"{[round(g, 2) for g in rep['upload_gbps']]})")
    print(f"[{tag}] Eq. (5)/(7) model at pcie_gbps={plan.offload.pcie_gbps}"
          f", cpu_flops={plan.offload.cpu_flops} (its inputs, not "
          f"measured): eq5_offload_ok {rep['eq5_offload_ok']}, "
          f"eq7_upload_ok {rep['eq7_upload_ok']}, predicted_overlap_ratio "
          f"{rep['predicted_overlap_ratio']:.4f}; measured_overlap_frac "
          f"{rep['measured_overlap_frac']:.4f}")
    print(f"[{tag}] launches {launches} (want {want})")
    bad = [i for i, (a, b) in enumerate(slabs)
           if not torch.equal(a.cpu(), b)]
    print(f"[{tag}] deep weights vs host masters rounded to bf16: "
          f"{len(slabs) - len(bad)} of {len(slabs)} leaf slabs bitwise "
          f"({steps} collects)")
    if not all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]):
        fail(f"{tag}: non-finite loss or grad_norm")
    masters = tree_leaves(out["opt_state"]["master"])
    unchanged = [i for i, (a, b) in enumerate(zip(before, masters))
                 if torch.equal(a, b.flatten()[:4096])]
    print(f"[{tag}] shallow and shared masters moved: "
          f"{n_leaves - len(unchanged)} of {n_leaves}")
    if unchanged:
        fail(f"{tag}: shallow master leaves {unchanged} did not change")
    if bad or len(slabs) != steps * len(tree_leaves(deep)):
        fail(f"{tag}: deep weights differ from their bf16 host masters "
             f"(slabs {bad} of {len(slabs)})")
    if out["losses"][0] != base["losses"][0]:
        fail(f"{tag}: step-1 loss {out['losses'][0]} != phase "
             f"{base['phase']}'s {base['losses'][0]}")
    if rep["submits"] != steps:
        fail(f"{tag}: {rep['submits']} submits in {steps} steps")
    if launches != want:
        fail(f"{tag}: kernel launches {launches} != expected {want}")
    if not fall >= 0.9 * deep_state:
        fail(f"{tag}: peak fell {fall / 2 ** 30:.3f} GiB, less than 0.9 x "
             f"the deep state's {deep_state / 2 ** 30:.3f} GiB")
    TRAIN_RUNS.append((tag, tc, P, peak))
    del out, params, kept, deep, slabs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_offload(torch, base):
    """11. ``train_pipeline`` with Chronos-Offload at full width:
    tinyllama-1.1b, then mamba2-2.7b, each against its on-device run
    (phases 6 and 8).  Returns the launch counts per path."""
    base["tinyllama-1.1b"]["phase"] = 6
    base["mamba2-2.7b"]["phase"] = 8
    tiny = train_offload_run(torch, "tinyllama-1.1b", "train-offload",
                             base["tinyllama-1.1b"], 4)
    done("train-offload tinyllama-1.1b")
    mamba = train_offload_run(torch, "mamba2-2.7b", "train-offload-mamba2",
                              base["mamba2-2.7b"], 4)
    done("train-offload mamba2-2.7b")
    return {"train_offload_tinyllama": tiny, "train_offload_mamba2": mamba}


def _fp32_offload_losses(torch, cfg, ocfg, mode: str):
    """3 steps of ``cfg`` (fp32), chronos_zb P=2, v=2, m=4, mbB=1, seq 257,
    seed 0, through ``train_pipeline``: ``mode`` "device" (the on-device
    optimizer), "offload" (the deep chunk's AdamW on the host), or
    "device+bf16" (the on-device step, its deep weights rounded to bf16
    after every step as the offload upload rounds them: the same data
    and weights, driven step by step)."""
    from repro_torch.configs.base import (OffloadConfig, ParallelPlan,
                                          ShapeConfig, TrainConfig)
    from repro_torch.core.pipeline_runtime import init_pipeline_params
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import (make_pipeline_train_step,
                                          offload_kept)
    from repro_torch.launch.train import train_pipeline
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves
    tc = TrainConfig(
        model=cfg, shape=ShapeConfig("t", 257, 4, "train"),
        plan=ParallelPlan(schedule="chronos_zb", num_chunks=2,
                          microbatch_size=1, num_microbatches=4,
                          kernels="fused",
                          offload=OffloadConfig(enabled=mode == "offload")),
        optimizer=ocfg, seed=0)
    if mode != "device+bf16":
        return train_pipeline(tc, P=2, device="cuda", steps=3,
                              log=lambda s: None)["losses"]
    dev = torch.device("cuda")
    step, m, mbB, spec = make_pipeline_train_step(cfg, tc.shape, tc.plan,
                                                  ocfg, P=2, device=dev)
    params = init_pipeline_params(
        torch.Generator(device=dev).manual_seed(tc.seed), cfg, spec.layout,
        dev)
    opt = adamw_init(params)
    src = SyntheticLM(cfg.vocab_size, 257, seed=tc.seed)
    _, deep = offload_kept(params, tc.plan)
    losses = []
    for _ in range(3):
        toks = torch.from_numpy(src.next_batch(m * mbB).reshape(m, mbB, -1))
        params, opt, met = step(params, opt, {"tokens": toks.to(dev)})
        losses.append(float(met["loss"]))
        for w in tree_leaves(deep):
            w.copy_(w.to(torch.bfloat16))
    return losses


def phase_train_offload_checks(torch):
    """fp32, full width, 4 layers, the optimizer of phases 6 and 8 with
    the gradient clip off, 3 steps, same weights and data
    (:func:`_fp32_offload_losses`): (a) offload against the port's
    on-device optimizer, step-1 losses bitwise, then within the
    reference's 5e-3; (b) offload against the on-device optimizer with
    the deep weights rounded to bf16 after every step, within 1e-4: what
    is left is the host update's own rounding.  Then the same pair with
    the clip on, printed and not checked: the host update never clips
    the deep gradients and the device clip covers only the shallow and
    shared leaves, as in the reference, so a clip coefficient that moves
    from step to step moves Adam's normalised steps apart."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig
    for arch in ("tinyllama-1.1b", "mamba2-2.7b"):
        cfg = dataclasses.replace(get_config(arch), num_layers=4,
                                  param_dtype="float32",
                                  compute_dtype="float32")
        for clip in (0.0, 1.0):
            ocfg = OptimizerConfig(warmup_steps=2, total_steps=4,
                                   grad_clip=clip)
            runs = {}
            for mode in ("device", "offload", "device+bf16"):
                runs[mode] = _fp32_offload_losses(torch, cfg, ocfg, mode)
                gc.collect()
                torch.cuda.empty_cache()
            off = runs["offload"]
            d_a = max(abs(a - b) for a, b in zip(runs["device"], off))
            d_b = max(abs(a - b) for a, b in zip(runs["device+bf16"], off))
            first = runs["device"][0] == off[0]
            print(f"[train-offload-check] {arch} fp32 4 layers, grad_clip "
                  f"{clip}, 3 steps: on-device {runs['device']}, offload "
                  f"{off}, on-device with bf16 deep weights "
                  f"{runs['device+bf16']}; offload - on-device max |d| "
                  f"{d_a:.3e}, offload - bf16-deep on-device max |d| "
                  f"{d_b:.3e}; step 1 "
                  f"{'bitwise' if first else 'DIFFERS'}"
                  + (" (tols 5e-3 and 1e-4)" if clip == 0.0 else
                     " (printed, not checked)"))
            if clip == 0.0 and not (first and d_a <= 5e-3 and d_b <= 1e-4):
                fail(f"{arch}: offload training departs from the on-device "
                     "optimizer")


# ---------------------------------------------------------------------------
# V-shape and sequence-chunked pipeline schedules
# ---------------------------------------------------------------------------

def phase_train_schedules(torch, bwd_ms, base):
    """Phases 12-14: full-width tinyllama-1.1b through ``train_pipeline``
    as phase 6 (seed, data, optimizer, fused kernels, P=4, m=8, one
    2049-token sequence per microbatch, 4 steps, launch counts from the
    table, a profiled step) with v_min (v=2, the fold-back placement,
    split backward and fused AdamW), and at ``SEQ_TRAIN_LAYERS`` layers
    chronos_seq (v=2, n_seq=2, ``RecomputeConfig("chronos",
    num_recomp_chunks=1)``) and seq1f1b (v=1, n_seq=4), each printed
    beside phase 6.  Returns the launch counts by path."""
    from repro_torch.configs.base import RecomputeConfig
    launches = {}
    ref = base["tinyllama-1.1b"]
    for tag, plan in (
            ("train-vshape", dict(schedule="v_min")),
            ("train-seq-chronos", dict(
                schedule="chronos_seq", seq_chunks=2,
                recompute=RecomputeConfig("chronos", num_recomp_chunks=1),
                layers=SEQ_TRAIN_LAYERS)),
            ("train-seq-1f1b", dict(schedule="seq1f1b", num_chunks=1,
                                    seq_chunks=4, layers=SEQ_TRAIN_LAYERS))):
        out = phase_train(torch, "tinyllama-1.1b", tag, bwd_ms, **plan)
        print(f"[{tag}] beside phase 6 ({ref['schedule']}; layers "
              f"{out['layers']} vs {ref['layers']}): median step "
              f"{out['median_s'] * 1e3:.1f} ms vs "
              f"{ref['median_s'] * 1e3:.1f} ms, "
              f"{out['tokens_per_s']:.1f} vs {ref['tokens_per_s']:.1f} "
              f"tokens/s, peak {out['peak'] / 2 ** 30:.3f} vs "
              f"{ref['peak'] / 2 ** 30:.3f} GiB, step-1 loss "
              f"{out['losses'][0]:.6f} vs {ref['losses'][0]:.6f}")
        launches[tag.replace("-", "_")] = out["launches"]
        done(f"{tag} tinyllama-1.1b")
    return launches


def _rel_err(got, want) -> float:
    """max |got - want| / max |want| over one tensor."""
    return max_err(got, want) / max(float(want.float().abs().max()), 1e-30)


def phase_train_schedule_checks(torch):
    """Phase 15, fp32, full width, 4 layers, P=2, m=4, mbB=1, seq 257
    (phase 7's sizes): (a) v_min, v_half and v_zb loss and gradients
    (fused kernels) against ``LM.loss`` autograd (plain backend, same
    weights); (b) v_min against the interleaved chronos (v=2) on the
    same network, its weights remapped by layer block; (c) chronos_seq
    (n_seq=2) against chronos and seq1f1b (n_seq=4) against 1f1b, with
    and without a loss mask.  Every pair within 2e-5 relative (per leaf:
    max|d| / max|ref|; the loss: |d| / |ref|)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                                   make_pipeline_spec,
                                                   make_train_grads_fn,
                                                   restage_params,
                                                   unstage_params)
    from repro_torch.models import LM
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=4,
                              param_dtype="float32", compute_dtype="float32")
    P, m, mbB, seq, tol = 2, 4, 1, 257, 2e-5

    def spec_of(schedule, v, **kw):
        return make_pipeline_spec(cfg, P=P, v=v, m=m, microbatch=mbB,
                                  seq_len=seq, schedule=schedule,
                                  kernels="fused", **kw)

    def run(spec, params, batch):
        g, met = make_train_grads_fn(spec, "cuda")(params, batch)
        return float(met["loss"]), tree_leaves(unstage_params(g,
                                                              spec.layout))

    def check(label, a, b):
        err = max([abs(a[0] - b[0]) / abs(b[0])]
                  + [_rel_err(x, y) for x, y in zip(a[1], b[1])])
        print(f"[train-check-schedules] {label}: loss {a[0]:.6f} vs "
              f"{b[0]:.6f}; max rel |d| loss and grads {err:.3e} (tol "
              f"{tol:g}) {'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            fail(f"phase 15 {label} disagree")

    tokens = torch.randint(0, cfg.vocab_size, (m, mbB, seq), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    mask = (torch.rand((m, mbB, seq - 1), device="cuda",
                       generator=torch.Generator(device="cuda")
                       .manual_seed(2)) > 0.3).float()
    # (a), (b): the V-shape family
    vmin = spec_of("v_min", 2)
    params = init_pipeline_params(torch.Generator(device="cuda")
                                  .manual_seed(0), cfg, vmin.layout, "cuda")
    lm = LM(cfg, kernels="plain", device="cuda")
    lp = tree_map(lambda a: a.detach().clone().requires_grad_(),
                  unstage_params(params, vmin.layout))
    ref_loss = sum(lm.loss(lp, {"tokens": tokens[i]})[0] for i in range(m))
    ref = (float(ref_loss.detach()) / m,
           list(torch.autograd.grad(ref_loss, tree_leaves(lp))))
    del lp, ref_loss
    batch = {"tokens": tokens}
    got = {}
    for name in ("v_min", "v_half", "v_zb"):
        got[name] = run(spec_of(name, 2), params, batch)
        check(f"(a) {name} fused vs LM.loss autograd", got[name], ref)
    ch = spec_of("chronos", 2)
    check("(b) v_min vs chronos (v=2), weights remapped by block",
          got["v_min"], run(ch, restage_params(params, vmin.layout,
                                               ch.layout), batch))
    # (c): the sequence-chunked family against its whole-sequence twin
    for seq_name, whole, v, ns in (("chronos_seq", "chronos", 2, 2),
                                   ("seq1f1b", "1f1b", 1, 4)):
        whole_spec = spec_of(whole, v)
        params = init_pipeline_params(
            torch.Generator(device="cuda").manual_seed(0), cfg,
            whole_spec.layout, "cuda")
        for b in (batch, {"tokens": tokens, "loss_mask": mask}):
            check(f"(c) {seq_name} n_seq={ns} vs {whole}"
                  + (", masked" if "loss_mask" in b else ""),
                  run(spec_of(seq_name, v, n_seq=ns), params, b),
                  run(whole_spec, params, b))


# ---------------------------------------------------------------------------
# the memory-budget planner: its picks trained, its peaks against the card's
# ---------------------------------------------------------------------------

PHASE_OF = {"train": 6, "train-mamba2": 8, "train-offload": 11,
            "train-offload-mamba2": 11, "train-vshape": 12,
            "train-seq-chronos": 13, "train-seq-1f1b": 14,
            "train-planner": "16a", "train-planner-deepseek": "16b",
            "train-qwen2-moe": "15a"}
PLANNER_RESERVE = 2.0e9          # PlannerQuery's default reserve


def planner_query(cfg, hbm_bytes: float, pp: int = 4):
    """The one-card query: ``pp`` virtual stages (4 unless given) share
    the card, each with ``hbm_bytes``; one 2049-token sequence per
    microbatch."""
    from repro_torch.plan import PlannerQuery
    return PlannerQuery(cfg=cfg, pp=pp, tp=1, hbm_bytes=hbm_bytes,
                        microbatch=1, seq_len=TRAIN_SEQ)


def _point_of(tc, q):
    """The planner's point for ``tc``'s plan under query ``q``."""
    from repro_torch.plan import enumerate_points
    plan = tc.plan
    from repro_torch.launch.steps import plan_schedule_kwargs
    kw = plan_schedule_kwargs(plan)
    n_off = plan.offload.num_offload_chunks if plan.offload.enabled else 0
    want = (plan.schedule, plan.num_chunks, plan.seq_chunks,
            kw.get("recomp_chunks", 0), kw.get("recomp", 0.0), n_off)
    for p in enumerate_points(q):
        if (p.schedule, p.v, p.seq_chunks, p.recomp_chunks,
                p.uniform_recomp, p.offload_chunks) == want:
            return p
    return None


def predicted_card_peak(tc, P: int):
    """The one-card reading of the planner's per-device model: the P
    virtual stages' model state, ``P x model_state``; the activations
    each stage's schedule holds at its own peak, ``sum_s
    peak_activation(per_stage=True)[s] x m_a``, at the run's microbatch
    count; for a sequence-chunked plan the planner's KV-carry term (a
    full-sequence K/V buffer and its dKV twin per in-flight microbatch)
    on each stage; and the planner's reserve once.  Returns (total, state,
    act, kv) in bytes."""
    from repro_torch.core.analysis import MemoryModel
    from repro_torch.core.pipeline_runtime import (SEQ_SCHEDULES,
                                                   _SCHEDULES_WITH_V)
    from repro_torch.core.schedules import get_schedule
    from repro_torch.launch.steps import plan_schedule_kwargs
    from repro_torch.plan.planner import _metrics
    cfg, plan = tc.model, tc.plan
    m = plan.num_microbatches or max(
        2, tc.shape.global_batch // plan.microbatch_size)
    kw = plan_schedule_kwargs(plan)
    if plan.schedule in SEQ_SCHEDULES:
        kw["n_seq"] = plan.seq_chunks
    if plan.schedule in _SCHEDULES_WITH_V:
        kw["v"] = plan.num_chunks
    sched = get_schedule(plan.schedule, P, m, **kw)
    mm = MemoryModel.build(cfg)
    L, tokens = cfg.num_layers, plan.microbatch_size * tc.shape.seq_len
    off = plan.offload.num_offload_chunks / plan.num_chunks \
        if plan.offload.enabled else 0.0
    state = P * mm.model_state(L, P, 1, offload_frac=off)
    act = sum(sched.peak_activation(per_stage=True)) * mm.m_a(tokens, L)
    kv = 0.0
    if sched.n_seq > 1:
        kv_frac = _metrics(plan.schedule, P, m, tuple(sorted(kw.items())))[4]
        kv = P * 2.0 * kv_frac * mm.kv_a(tokens, L)
    return state + act + kv + PLANNER_RESERVE, state, act, kv


def planner_run(torch, tag: str, tc, steps: int):
    """``tc`` (a planner pick's plan) trained ``steps`` steps through
    ``train_pipeline`` on P=4 virtual stages at full width, bf16, seed 0.
    Gates: finite losses and gradient norms, every master leaf the card
    updates moved (under offload: the shallow and shared ones; the deep
    ones move on the host), every launch count equal to the one derived
    from the task table (fused AdamW once per updated leaf where the
    table has W tasks).  Prints the step time, tokens/s and peak, and
    under offload ``collect_wait_s`` and the host update seconds; each
    step's peak up to its optimizer update and within it are read apart
    by wrapping the update (the peak counter reset around it).
    Returns (launches, peak, median step)."""
    from repro_torch.core import pipeline_runtime as prt
    from repro_torch.launch.steps import offload_kept
    from repro_torch.launch.train import train_pipeline
    from repro_torch.tree import tree_leaves
    P, plan = 4, tc.plan
    spec = _spec_of(tc, P)
    tab, lay = spec.table, spec.layout
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(tc.seed)
    params = prt.init_pipeline_params(gen, tc.model, spec.layout, "cuda")
    offload = plan.offload.enabled
    kept = offload_kept(params, plan)[0] if offload else params
    n_params = sum(a.numel() for a in tree_leaves(params))
    before = [a.flatten()[:4096].to(torch.float32, copy=True)
              for a in tree_leaves(kept)]
    print(f"[{tag}] {tc.model.name} full width bf16 ({tc.model.num_layers} "
          f"layers), {tab.name} ({lay.pl.name} placement) P={P} v={lay.v} "
          f"m={tab.m} n_seq={tab.n_seq} mbB={spec.mbB} seq {spec.S}, "
          f"recompute {plan.recompute.mode}/{plan.recompute.num_recomp_chunks}"
          f", offload {plan.offload.num_offload_chunks if offload else 0}/"
          f"{plan.num_chunks}: L_pad={lay.L_pad} K={lay.K}, "
          f"{n_params / 1e9:.3f} B parameters; table T={tab.T} act "
          f"{tab.act_depth} kv {tab.kv_depth} wstash {tab.wstash_depth} rmt "
          f"{tab.rmt_depth}; host {os.cpu_count()} CPUs, MemTotal "
          f"{_host_memory()}")
    kernels = _kernel_fns()
    before_upd, in_upd = [], []         # peak bytes of each step's parts
    update = prt.adamw_update

    def marked_update(*a, **k):
        before_upd.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        out = update(*a, **k)
        in_upd.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    prt.adamw_update = marked_update
    try:
        out = train_pipeline(tc, P=P, device="cuda", steps=steps,
                             params=params,
                             log=lambda s: print(f"[{tag}] {s}", flush=True))
    finally:
        prt.adamw_update = update
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = max(before_upd + in_upd + [torch.cuda.max_memory_allocated()])
    per_step = expected_train_launches(spec, len(before))
    want = {k: steps * n for k, n in per_step.items()}
    tokens = tab.m * spec.mbB * spec.S
    med = statistics.median(out["step_s"][1:])      # step 1 warms up
    print(f"[{tag}] losses={out['losses']} grad_norms={out['grad_norms']} "
          f"step_s={out['step_s']}")
    print(f"[{tag}] median step {med * 1e3:.1f} ms (steps 2-{steps}: "
          f"{[round(t * 1e3, 1) for t in out['step_s'][1:]]}), {tokens} "
          f"tokens/step -> {tokens / med:.1f} tokens/s; "
          f"max_memory_allocated={peak / 2 ** 30:.3f} GiB; per step, the "
          f"peak up to the optimizer update "
          f"{[round(b / 2 ** 30, 3) for b in before_upd]} GiB and within "
          f"it {[round(b / 2 ** 30, 3) for b in in_upd]} GiB")
    if offload:
        rep = out["offload"]
        print(f"[{tag}] offload: collect_wait_s {rep['collect_wait_s']:.3f}"
              f", host update s {[round(t, 3) for t in rep['host_update_s']]}"
              f", overlapped/submits {rep['overlapped']}/{rep['submits']}")
    print(f"[{tag}] launches {launches} (want {want})")
    if not all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]):
        fail(f"{tag}: non-finite loss or grad_norm")
    masters = tree_leaves(out["opt_state"]["master"])
    unchanged = [i for i, (a, b) in enumerate(zip(before, masters))
                 if torch.equal(a, b.flatten()[:4096])]
    print(f"[{tag}] masters moved: {len(masters) - len(unchanged)} of "
          f"{len(masters)} leaves updated on the card")
    if unchanged or len(masters) != len(before):
        fail(f"{tag}: master leaves {unchanged} did not change")
    if launches != want:
        fail(f"{tag}: kernel launches {launches} != expected {want}")
    TRAIN_RUNS.append((tag, tc, P, peak))
    del out, params, kept
    gc.collect()
    torch.cuda.empty_cache()
    return launches, peak, med


def phase_train_planner(torch):
    """16. The memory-budget planner on the card: (a) its pick for
    tinyllama-1.1b under a quarter of the card per stage, trained 4
    steps as phase 6 (8 sequences of 2049 tokens); (b) for deepseek-7b's
    published width, ``max_trainable_layers`` of ``1f1b`` and of the
    best point under the same budget, then the pick at the best depth
    trained 2 steps with ``ep.m`` sequences; (c) for every pipeline
    training plan of this run, the planner's per-stage total, the
    one-card prediction with its terms and the measured peak.  Returns
    the launch counts by path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import (OptimizerConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.plan import enumerate_points, plan_under_budget
    hbm = torch.cuda.get_device_properties(0).total_memory / 4
    print(f"[train-planner] per-stage budget: total_memory / 4 = "
          f"{hbm / 1e9:.3f} GB")
    launches = {}

    def trained(tag, cfg, ep, m, steps):
        plan = ep.parallel_plan()
        print(f"[{tag}] pick {json.dumps(ep.summary())}")
        print(f"[{tag}] plan {plan}")
        tc = TrainConfig(model=cfg, shape=ShapeConfig(
            "train_2k", seq_len=TRAIN_SEQ, global_batch=m, kind="train"),
            plan=plan, optimizer=OptimizerConfig(warmup_steps=2,
                                                 total_steps=4),
            seed=0, log_every=1)
        return planner_run(torch, tag, tc, steps)

    # (a) tinyllama-1.1b
    cfg = get_config("tinyllama-1.1b")
    ep = plan_under_budget(cfg, pp=4, tp=1, hbm_bytes=hbm, microbatch=1,
                           seq_len=TRAIN_SEQ)
    launches["train_planner_tinyllama"] = trained(
        "train-planner", cfg, ep, 8, 4)[0]
    done("train-planner tinyllama-1.1b")

    # (b) the largest deepseek-7b one card trains
    wide = get_config("deepseek-7b")
    pts = enumerate_points(planner_query(wide, hbm))
    ladder = {}
    for p in pts:
        ladder.setdefault(p.describe(), p.max_layers)
    best = max(pts, key=lambda p: p.max_layers)
    depth = best.max_layers
    print(f"[train-planner-deepseek] deepseek-7b width (d 4096, 32 heads, "
          f"d_ff 11008, vocab 102400) under {hbm / 1e9:.3f} GB per stage: "
          f"max_trainable_layers 1f1b {ladder['1f1b']}, best "
          f"{best.describe()} {depth} ({depth / max(ladder['1f1b'], 1):.2f}"
          f"x); at its 30 published layers {sum(p.fits for p in pts)} of "
          f"{len(pts)} points fit")
    if depth < 1:
        fail("train-planner-deepseek: no depth of deepseek-7b fits")
    deep_cfg = dataclasses.replace(wide, num_layers=depth)
    ep = plan_under_budget(deep_cfg, pp=4, tp=1, hbm_bytes=hbm,
                           microbatch=1, seq_len=TRAIN_SEQ)
    unit = 4 * ep.point.v
    if depth % unit:
        print(f"[train-planner-deepseek] {depth} layers pad to "
              f"{-(-depth // unit) * unit}: the padding layers hold weights "
              f"and optimizer state the model does not count")
    n, peak_b, med_b = trained("train-planner-deepseek", deep_cfg, ep, ep.m,
                               2)
    launches["train_planner_deepseek"] = n
    tokens = ep.m * (TRAIN_SEQ - 1)
    print(f"[train-planner-deepseek] {depth} layers "
          f"({deep_cfg.param_count() / 1e9:.3f} B parameters) trained on "
          f"one card: step {med_b * 1e3:.1f} ms, {tokens / med_b:.1f} "
          f"tokens/s, peak {peak_b / 2 ** 30:.3f} GiB; 1f1b fits "
          f"{ladder['1f1b']} layers")
    done("train-planner deepseek-7b")

    # (c) every pipeline training plan: predicted against measured
    for tag, tc, P, peak in TRAIN_RUNS:
        total, state, act, kv = predicted_card_peak(tc, P)
        pt = _point_of(tc, planner_query(tc.model, hbm * 4 / P, pp=P))
        per_stage = f"{pt.total_bytes / 2 ** 30:.3f} GiB ({pt.describe()})" \
            if pt is not None else "not a point of the design space"
        print(f"[train-planner-model] phase {PHASE_OF[tag]} {tag} "
              f"{tc.model.name} {tc.plan.schedule}: planner per-stage total "
              f"{per_stage}; card prediction {total / 2 ** 30:.3f} GiB = "
              f"{P} x model_state {state / 2 ** 30:.3f} + activations "
              f"{act / 2 ** 30:.3f} + kv-carry {kv / 2 ** 30:.3f} + reserve "
              f"{PLANNER_RESERVE / 2 ** 30:.3f}; measured peak "
              f"{peak / 2 ** 30:.3f} GiB; measured / predicted "
              f"{peak / total:.3f}")
    return launches


# ---------------------------------------------------------------------------
# windowed layers, the VLM patch prefix and the encoder-decoder (gemma3-27b,
# paligemma-3b, whisper-base)
# ---------------------------------------------------------------------------

GEMMA3_ARGV = ["--chunk", "128", "--prompt-chunks", "12",
               "--prompt-len", "1536"]     # max_seq = 1536 + 32 + 512


def phase_serve_gemma3(torch):
    """17. gemma3-27b served at full width through ``launch.serve.main``
    (P=1, 4 slots, 128-token chunks, prompts of 1-12 chunks, 16-32 new
    tokens, 8 requests at t=0), gated as phase 4; the requests whose
    prompts pass the 1024-token window (at least two), the peak beside
    its reckoning, then the warm profiled re-run.  Returns the launch
    counts."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma3-27b")
    argv = serve_argv("gemma3-27b")
    for i in range(0, len(GEMMA3_ARGV), 2):
        argv[argv.index(GEMMA3_ARGV[i]) + 1] = GEMMA3_ARGV[i + 1]
    gc.collect()
    torch.cuda.empty_cache()
    launches, eng, s = phase_serve(torch, argv, "serve-gemma3")
    from repro_torch.serve import poisson_requests
    reqs = poisson_requests(8, 1e9, chunk=eng.chunk, max_seq=eng.max_seq,
                            prompt_range=(1, 12), gen_range=(16, 32),
                            vocab=cfg.vocab_size, seed=0)
    past = [len(r.prompt) for r in reqs if len(r.prompt) > cfg.sliding_window]
    print(f"[serve-gemma3] prompts past the {cfg.sliding_window}-token "
          f"window: {len(past)} of {len(reqs)} ({past} tokens; their "
          f"prefill chunks and decode steps mask real keys in the 52 local "
          f"layers)")
    if len(past) < 2:
        fail("serve-gemma3: fewer than two prompts pass the window")
    wbytes = cfg.param_count() * 2
    kv = 2 * cfg.num_layers * eng.n_slots * eng.max_seq * \
        cfg.num_kv_heads * cfg.resolved_head_dim * 2
    leaf = cfg.num_layers * cfg.d_model * cfg.d_ff * 2
    print(f"[serve-gemma3] peak {s['peak'] / 2 ** 30:.3f} GiB against the "
          f"reckoning: weights {wbytes / 1e9:.1f} GB + the largest block "
          f"leaf while the pack builds it {leaf / 1e9:.1f} GB = "
          f"{(wbytes + leaf) / 2 ** 30:.1f} GiB; serving: weights + K/V "
          f"{kv / 1e9:.2f} GB = {(wbytes + kv) / 2 ** 30:.1f} GiB and "
          f"the activations (the old copying pack needed "
          f"{2 * wbytes / 1e9:.1f} GB)")
    phase_profile(torch, eng, "serve-gemma3")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_gemma3_checks(torch):
    """17a. (a) reduced gemma3 (window 32) in fp32 on the card: the
    engine's greedy streams and logits at P=2 equal P=1's, over prompts of
    48 and 64 tokens; (b) full width, fp32, 6 layers (five local, one
    global): the fused and plain backends agree on the logits of three
    512-token prefill chunks and four decode steps (positions past the
    1024-token window) within 1e-3."""
    import dataclasses

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import LM
    from repro_torch.serve import PipelinedEngine, Request
    cfg = get_reduced("gemma3-27b")
    lm = LM(cfg, device="cuda")
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(rid=i, prompt=torch.randint(
        0, cfg.vocab_size, (16 * (3 + i),), generator=rng).tolist(),
        max_new=8) for i in range(2)]
    streams, logits = {}, {}
    for P in (1, 2):
        eng = PipelinedEngine(cfg, params, P=P, chunk=16, max_seq=96,
                              n_slots=2, device="cuda")
        got, tick = {}, eng.tick

        def recording(inj, tick=tick, got=got):
            retired, tok, lg = tick(inj)
            if lg is not None:
                got.setdefault(retired.rid, []).append(lg.float().cpu())
            return retired, tok, lg
        eng.tick = recording
        res = eng.serve(reqs, clock=None)
        streams[P] = {r: rec.tokens for r, rec in res["finished"].items()}
        logits[P] = got
    worst = max(float((a - b).abs().max()) for r in logits[1]
                for a, b in zip(logits[1][r], logits[2][r]))
    print(f"[serve-gemma3-check] (a) reduced gemma3 fp32 (window "
          f"{cfg.sliding_window}, prompts 48 and 64): P=2 streams "
          f"{'==' if streams[1] == streams[2] else '!='} P=1 streams "
          f"{streams[1]}; logits max|d| {worst:.3e} (tol 1e-5)")
    if streams[1] != streams[2] or not worst <= 1e-5:
        fail("gemma3: the engine's P=2 streams differ from P=1's")
    cfg32 = dataclasses.replace(get_config("gemma3-27b"), num_layers=6,
                                param_dtype="float32",
                                compute_dtype="float32")
    fused = LM(cfg32, kernels="fused", device="cuda")
    plain = LM(cfg32, kernels="plain", device="cuda")
    params = fused.init(torch.Generator(device="cuda").manual_seed(0))
    chunk, n_chunks = 512, 3
    prompt = torch.randint(0, cfg32.vocab_size, (1, chunk * n_chunks),
                           generator=rng).to("cuda")
    caches = {"fused": fused.init_cache(1, chunk * n_chunks + 8),
              "plain": plain.init_cache(1, chunk * n_chunks + 8)}
    worst, pos, tok = 0.0, 0, None
    for step in range(n_chunks + 4):
        out = {}
        for name, lm_ in (("fused", fused), ("plain", plain)):
            if step < n_chunks:
                out[name], _ = lm_.prefill_chunk(
                    params, prompt[:, chunk * step:chunk * (step + 1)],
                    caches[name], pos)
            else:
                out[name], _ = lm_.decode_step(params, tok, caches[name], pos)
        if not bool(torch.isfinite(out["fused"]).all()):
            fail("gemma3: non-finite fp32 logits")
        worst = max(worst, max_err(out["fused"], out["plain"]))
        pos += chunk if step < n_chunks else 1
        tok = out["fused"].argmax(-1, keepdim=True)
    print(f"[serve-gemma3-check] (b) full width fp32, 6 layers, fused vs "
          f"plain logits over {n_chunks} prefill chunks of {chunk} and 4 "
          f"decode steps (to position {pos}): max|d| {worst:.3e} (tol 1e-3)")
    if not worst <= 1e-3:
        fail("gemma3: fused and plain backends disagree on fp32 logits")
    del fused, plain, params, caches
    gc.collect()
    torch.cuda.empty_cache()


def single_host_stream(torch, arch: str, tag: str, prompt_len: int,
                       n_new: int = 9):
    """Full width, bf16, one request on the single-host ``LM``:
    ``prefill`` of a ``prompt_len``-token prompt with the config's patch
    or frame embeddings (fp32, from the seed), then ``n_new - 1`` greedy
    ``decode_step`` s.  Checks finite logits, every prefill layer on the
    flash kernel (an encoder's layers too) and none in decode (which
    reads cached cross K/V); prints the tokens, times and the peak."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_source
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import LM
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, device="cuda")
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    flat = synthetic_source(cfg, prompt_len, seed=2).next_batch(1)
    kw = {k: torch.from_numpy(a).to("cuda") for k, a in flat.items()}
    tokens = kw.pop("tokens")
    pre = cfg.vision.num_patches if cfg.vision is not None else 0
    cache = lm.init_cache(1, pre + prompt_len + n_new)
    n_enc = cfg.encdec.num_encoder_layers if cfg.encdec is not None else 0
    kernels = _kernel_fns()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, tokens, cache, **kw)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    n_pre = flash_attention_fwd.launches
    out, finite, pos = [], bool(torch.isfinite(logits).all()), \
        pre + prompt_len
    t0 = time.perf_counter()
    for _ in range(n_new):
        tok = logits.argmax(-1, keepdim=True)
        out.append(int(tok))
        if len(out) == n_new:
            break
        logits, cache = lm.decode_step(params, tok, cache, pos)
        finite &= bool(torch.isfinite(logits).all())
        pos += 1
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / (n_new - 1)
    n_dec = flash_attention_fwd.launches - n_pre
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {cfg.name} full width bf16, single-host prefill of "
          f"{f'{pre} patches + ' if pre else ''}{prompt_len} tokens"
          f"{f' over {cfg.encdec.num_frames} frames' if n_enc else ''}: "
          f"{t_pre * 1e3:.1f} ms, then {n_new - 1} greedy decode steps at "
          f"{t_dec * 1e3:.2f} ms each; tokens {out}; flash launches "
          f"prefill {n_pre} (want {cfg.num_layers + n_enc}), decode {n_dec} "
          f"(want 0); launches {launches}; max_memory_allocated "
          f"{peak / 2 ** 30:.3f} GiB")
    if not finite:
        fail(f"{tag}: non-finite logits")
    if n_pre != cfg.num_layers + n_enc or n_dec:
        fail(f"{tag}: flash launches prefill {n_pre}, decode {n_dec}")
    del lm, params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_a4(torch, arch: str, tag: str, P: int, seq: int):
    """18-19. ``arch`` trained 4 steps at full width through
    ``train_pipeline`` (chronos_zb, v=2, 8 microbatches of one sequence of
    ``seq`` tokens, with the synthetic source's fp32 patch or frame
    embeddings), gated as phase 6 (launch counts from the task table,
    with the encoder on the first chunk's ops), the peak printed beside
    ``predicted_card_peak``."""
    out = phase_train(torch, arch, tag, None, P=P, seq=seq)
    tc = _train_config(arch, seq=seq)
    total, state, act, kv = predicted_card_peak(tc, P)
    print(f"[{tag}] peak {out['peak'] / 2 ** 30:.3f} GiB against the card "
          f"prediction {total / 2 ** 30:.3f} GiB ({P} x model_state "
          f"{state / 2 ** 30:.3f} + activations {act / 2 ** 30:.3f} + "
          f"reserve {PLANNER_RESERVE / 2 ** 30:.3f}); measured / predicted "
          f"{out['peak'] / total:.3f}")
    return out


def _fp32_pipe_check(torch, tag, cfg, P, v, seq, schedules, m=4):
    """``cfg`` (fp32) on the card: pipeline loss and gradients (fused
    kernels) of each of ``schedules`` against ``LM.loss`` autograd (plain
    backend, same weights) over ``m`` microbatches of one ``seq``-token
    sequence with the config's fp32 patch or frame embeddings; every leaf
    (the encoder's too) within 2e-5 of its largest element, the loss
    within 2e-5 relative."""
    from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                                   make_pipeline_spec,
                                                   make_train_grads_fn,
                                                   unstage_params)
    from repro_torch.data import synthetic_source
    from repro_torch.models import LM
    from repro_torch.tree import tree_leaves, tree_map
    tol = 2e-5
    gc.collect()
    torch.cuda.empty_cache()
    flat = synthetic_source(cfg, seq, seed=3).next_batch(m)
    if not isinstance(flat, dict):
        flat = {"tokens": flat}
    batch = {k: torch.from_numpy(a.reshape((m, 1) + a.shape[1:])).to("cuda")
             for k, a in flat.items()}
    specs = {s: make_pipeline_spec(cfg, P=P, v=v, m=m, microbatch=1,
                                   seq_len=seq, schedule=s, kernels="fused")
             for s in schedules}
    base = specs[schedules[0]]
    assert all(sp.layout == base.layout for sp in specs.values())
    params = init_pipeline_params(torch.Generator(device="cuda")
                                  .manual_seed(0), cfg, base.layout, "cuda")
    lm = LM(cfg, kernels="plain", device="cuda")
    lp = tree_map(lambda a: a.detach().clone().requires_grad_(),
                  unstage_params(params, base.layout))
    ref_loss = 0.0
    ref = None
    for i in range(m):
        loss = lm.loss(lp, {k: a[i] for k, a in batch.items()})[0]
        g = torch.autograd.grad(loss, tree_leaves(lp))
        ref = list(g) if ref is None else [a.add_(b) for a, b in zip(ref, g)]
        ref_loss += float(loss.detach()) / m
        del loss, g
    del lp
    for s in schedules:
        g, met = make_train_grads_fn(specs[s], "cuda")(params, batch)
        gu = unstage_params(g, specs[s].layout)
        del g
        got = tree_leaves(gu)
        n_enc = len(tree_leaves(gu.get("encoder", []))) + \
            len(tree_leaves(gu.get("enc_norm", {})))
        err = max([abs(float(met["loss"]) - ref_loss) / abs(ref_loss)]
                  + [_rel_err(a, b) for a, b in zip(got, ref)])
        print(f"[{tag}] {cfg.name} fp32 ({cfg.num_layers} layers, d "
              f"{cfg.d_model}, head dim {cfg.resolved_head_dim}, window "
              f"{cfg.sliding_window}, seq {seq}) {s} P={P} fused vs "
              f"LM.loss autograd: loss {float(met['loss']):.6f} vs "
              f"{ref_loss:.6f}; max rel |d| loss and {len(got)} grads "
              f"({n_enc} of the encoder) {err:.3e} (tol {tol:g}) "
              f"{'ok' if err <= tol else 'FAIL'}")
        if len(got) != len(ref) or not err <= tol:
            fail(f"{tag}: {cfg.name} {s} pipeline gradients disagree with "
                 f"LM.loss autograd")
        del gu, got
    del params, ref
    gc.collect()
    torch.cuda.empty_cache()


def phase_a4_checks(torch):
    """20. fp32 on the card, reduced depth: pipeline loss and gradients
    against ``LM.loss`` autograd at 2e-5 for gemma3 at full width, 6
    layers (five local, one global) with its window cut to 256 under
    512 positions; paligemma at head dim 256 (d 512, 4 heads over 1 K/V
    head) with its 256 patches; whisper-base at full width with its
    encoder's gradients."""
    import dataclasses

    from repro_torch.configs import get_config
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    _fp32_pipe_check(torch, "train-check-gemma3", dataclasses.replace(
        get_config("gemma3-27b"), num_layers=6, sliding_window=256, **f32),
        P=3, v=2, seq=513, schedules=("chronos_zb",))
    _fp32_pipe_check(torch, "train-check-paligemma", dataclasses.replace(
        get_config("paligemma-3b"), num_layers=4, d_model=512, num_heads=4,
        d_ff=2048, **f32), P=2, v=2, seq=257,
        schedules=("chronos_zb", "chronos"))
    _fp32_pipe_check(torch, "train-check-whisper", dataclasses.replace(
        get_config("whisper-base"), **f32), P=3, v=2, seq=449,
        schedules=("chronos_zb", "chronos"))


ELASTIC_LAYERS = 8       # tinyllama-1.1b cut from 22: a save is 14 B a
#                          parameter (bf16 weight, fp32 mu, nu, master)
ELASTIC_STEPS = 6
# faulted against baseline losses.  The gradients of a layer are the same
# at any P (same ops per position, microbatches in the same order); the
# gradient norm sums leaves of other shapes at P=3, so the clip factor
# may move by an fp32 ulp, which AdamW's mu / sqrt(nu) all but cancels:
# a few bf16 weights may round the other way.  1e-4 is ~100 ulps of the
# fp32 loss at 10.4 (the reference's CPU drill: 1e-5).
ELASTIC_LOSS_TOL = 1e-4
# train() resumed against uninterrupted: the same ops on the same inputs,
# expected bitwise; the bound is _train_pair's (losses 1e-5, fp32
# masters 1e-6 but for a 1e-3 share)
RESUME_LOSS_TOL, RESUME_W_TOL, RESUME_W_FRAC = 1e-5, 1e-6, 1e-3


def save_bytes(cfg, P: int, v: int = 2) -> int:
    """Bytes of one pipeline checkpoint of ``cfg`` (bf16 weights) at P
    virtual stages: every parameter of the L_pad layers the layout holds
    and the shared ones, 2 B of weight and 12 B of fp32 mu, nu and
    master each, and the int32 step."""
    import dataclasses

    from repro_torch.core.layout import StageLayout
    from repro_torch.core.placement import get_placement
    lay = StageLayout.build(cfg, P, v, get_placement("interleaved", P, v))
    n = dataclasses.replace(cfg, num_layers=lay.L_pad).param_count()
    return 14 * (n + cfg.d_model) + 4


def print_checkpoint_records(tag: str, records) -> None:
    """One line per save (GB; device-to-host and to-disk seconds and
    GB/s) and per restore (GB; disk and host-to-device)."""
    def rate(gb, s):
        return f"{s:.3f} s ({gb / s:.2f} GB/s)" if s else "0 s"
    for r in records:
        gb = r["bytes"] / 1e9
        if r["op"] == "save":
            w = r["write_s"]
            print(f"[{tag}] save step {r['step']} ({r['mode']}): {gb:.3f} "
                  f"GB, device->host {rate(gb, r['d2h_s'])}, to disk "
                  + (rate(gb, w) if w is not None
                     else f"died: {r.get('error')}"))
        else:
            print(f"[{tag}] restore step {r['step']}: {gb:.3f} GB, from "
                  f"disk {rate(gb, r['read_s'])}, host->device "
                  f"{rate(gb, r['h2d_s'])}")


def phase_train_elastic(torch):
    """21. The elastic drill (``train_elastic``): full-width tinyllama-1.1b
    cut to ``ELASTIC_LAYERS`` layers, chronos_zb v=2, fused kernels, 4
    microbatches of one 2049-token sequence, ``ELASTIC_STEPS`` steps,
    checkpoints every 2 steps (keep 2) in a temporary directory, on P=4
    virtual stages with the reference drill's faults: the checkpoint
    writer dies before its rename at step 2, stage slot 1 is lost at step
    3 and rejoins at step 5.  Held against ``train_pipeline`` at P=4
    without checkpoints: P [4, 3, 4], both recoveries with restore and
    remap, every step's loss within ``ELASTIC_LOSS_TOL``, the LATEST
    checkpoint bitwise the returned state, launches from the tables of
    the steps each incarnation ran, each save the reckoned size.
    Returns the launch counts."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.ft.checkpoint import Checkpointer
    from repro_torch.ft.elastic_pipeline import train_elastic
    from repro_torch.ft.inject import CheckpointCrash, DeviceJoin, DeviceLoss
    from repro_torch.launch.train import train_pipeline
    from repro_torch.tree import tree_leaves
    tag = "train-elastic"
    tc = _train_config("tinyllama-1.1b", layers=ELASTIC_LAYERS,
                       num_microbatches=4)
    tc = dataclasses.replace(
        tc, shape=dataclasses.replace(tc.shape, global_batch=4),
        optimizer=dataclasses.replace(tc.optimizer,
                                      total_steps=ELASTIC_STEPS),
        checkpoint_every=2, keep_checkpoints=2)
    sizes = {P: save_bytes(tc.model, P) for P in (4, 3)}

    def log(s):
        print(f"[{tag}] {s}", flush=True)
    with tempfile.TemporaryDirectory() as d:
        free = shutil.disk_usage(d).free
        print(f"[{tag}] {tc.model.name} full width bf16, {ELASTIC_LAYERS} "
              f"layers, chronos_zb v=2, 4 x 1 x {TRAIN_SEQ} tokens, "
              f"{ELASTIC_STEPS} steps; checkpoint dir {d}: {free} bytes "
              f"free; a save is {sizes[4]} B at P=4 (L_pad 8), {sizes[3]} "
              f"B at P=3 (L_pad 12)")
        if free < 3 * sizes[3]:
            fail(f"{tag}: {free} bytes free in {d}, below 3 saves "
                 f"({3 * sizes[3]} B)")
        gc.collect()
        torch.cuda.empty_cache()
        base = train_pipeline(tc, P=4, device="cuda", steps=ELASTIC_STEPS,
                              log=log)
        base_losses, base_s = base["losses"], base["step_s"]
        del base
        gc.collect()
        torch.cuda.empty_cache()
        kernels = _kernel_fns()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        faults = [CheckpointCrash(step=2, at="rename"),
                  DeviceLoss(step=3, device=1), DeviceJoin(step=5, device=1)]
        t0 = time.perf_counter()
        out = train_elastic(dataclasses.replace(tc, checkpoint_dir=d),
                            n_devices=4, faults=faults, steps=ELASTIC_STEPS,
                            device="cuda", log=log)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        tree = {"params": out["params"], "opt": out["opt_state"]}
        restored, _ = Checkpointer(d).restore(tree)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(tree),
                                                     tree_leaves(restored)))
        del restored
        latest = Checkpointer(d).latest_step()
    incs, recs = out["incarnations"], out["recoveries"]
    print_checkpoint_records(tag, out["checkpoint_records"])
    for r in recs:
        print(f"[{tag}] recovery {r.kind}:{r.p_from}->{r.p_to} at step "
              f"{r.step}: detect {r.detect_s:.3f} s, replan "
              f"{r.replan_s:.3f} s, restore {r.restore_s:.3f} s, remap + "
              f"re-save {r.remap_s:.3f} s, resume (to the first step's "
              f"end) {r.resume_s:.3f} s")
    for i in incs:
        print(f"[{tag}] incarnation P={i['P']} {i['status']}: {i['steps']} "
              f"steps, step_s {[round(t, 4) for t in i['step_s']]}")
    step_ms = {P: [t * 1e3 for i in incs if i["P"] == P
                   for t in i["step_s"][1:]] for P in (4, 3)}
    print(f"[{tag}] median step at P=4 {statistics.median(step_ms[4]):.1f} "
          f"ms, at P=3 {statistics.median(step_ms[3]):.1f} ms (each "
          f"incarnation's first step left out); baseline P=4 "
          f"{statistics.median(base_s[1:]) * 1e3:.1f} ms; drill wall "
          f"{wall:.1f} s; max_memory_allocated {peak / 2 ** 30:.3f} GiB")
    ps = [i["P"] for i in incs]
    kinds = [(r.kind, r.p_from, r.p_to) for r in recs]
    steps_seen = sorted(out["loss_by_step"])
    err = max(abs(out["loss_by_step"][s] - base_losses[s])
              for s in range(ELASTIC_STEPS))
    print(f"[{tag}] P {ps}; recoveries {kinds}; steps {steps_seen}; max "
          f"|faulted - baseline| loss {err:.3e} (tol {ELASTIC_LOSS_TOL:g}"
          f"{', bitwise' if err == 0 else ''}); LATEST step {latest} "
          f"restored == returned state: {same}")
    n_leaves = len(tree_leaves(out["params"]))
    want = {}
    for i in incs:
        per = expected_train_launches(_spec_of(tc, i["P"]), n_leaves)
        want = {k: want.get(k, 0) + i["steps"] * n for k, n in per.items()}
    print(f"[{tag}] launches {launches} (from the tables of the steps "
          f"each incarnation ran: {want})")
    save_sizes = {r["bytes"] for r in out["checkpoint_records"]
                  if r["op"] == "save"}
    if ps != [4, 3, 4]:
        fail(f"{tag}: incarnations ran P {ps}, not [4, 3, 4]")
    if kinds != [("device_loss", 4, 3), ("scale_up", 3, 4)] or not all(
            r.restore_s > 0 and r.remap_s > 0 for r in recs):
        fail(f"{tag}: recoveries {recs}")
    if steps_seen != list(range(ELASTIC_STEPS)):
        fail(f"{tag}: not step-count exact: steps {steps_seen}")
    if not err <= ELASTIC_LOSS_TOL:
        fail(f"{tag}: faulted losses {out['losses']} against baseline "
             f"{base_losses}: max |d| {err:.3e} > {ELASTIC_LOSS_TOL}")
    if not same or latest != ELASTIC_STEPS:
        fail(f"{tag}: the LATEST checkpoint (step {latest}) does not "
             "restore to the returned state")
    if launches != want:
        fail(f"{tag}: kernel launches {launches} != expected {want}")
    if not save_sizes <= set(sizes.values()):
        fail(f"{tag}: save sizes {save_sizes} not the reckoned {sizes}")
    del out, tree
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_resume(torch):
    """22. ``train()`` resumed: full-width tinyllama-1.1b cut to 2 layers,
    recompute chronos, 2 microbatches of 4 x 2049 tokens, the plain
    AdamW update.  5 uninterrupted steps, against 3 steps with a
    checkpoint every step and a second ``train()`` call on the same
    directory that restores and runs steps 3-4: their losses and the
    final fp32 masters within ``RESUME_*`` (expected bitwise).  Returns
    the resumed calls' launch counts."""
    import dataclasses
    import tempfile

    from repro_torch.configs.base import RecomputeConfig
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_leaves
    tag = "train-resume"
    tc = _single_config("tinyllama-1.1b", RecomputeConfig(
        "chronos", num_recomp_chunks=1, policy="full"), 4)
    tc = dataclasses.replace(
        tc, model=dataclasses.replace(tc.model, num_layers=2),
        optimizer=dataclasses.replace(tc.optimizer, total_steps=5))
    m = tc.shape.global_batch // tc.plan.microbatch_size

    def log(s):
        print(f"[{tag}] {s}", flush=True)
    print(f"[{tag}] {tc.model.name} full width bf16, 2 layers, through "
          f"train(): recompute chronos, {m} microbatches of 4 x "
          f"{TRAIN_SEQ} tokens; 5 steps, then 3 + a resumed 2")
    gc.collect()
    torch.cuda.empty_cache()
    full = train(tc, device="cuda", steps=5, log=log)
    kernels = _kernel_fns()
    for fn in kernels.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as d:
        tcr = dataclasses.replace(tc, checkpoint_dir=d, checkpoint_every=1)
        first = train(tcr, device="cuda", steps=3, log=log)
        rest = train(tcr, device="cuda", steps=5, log=log)
    launches = {k: fn.launches for k, fn in kernels.items()}
    print_checkpoint_records(tag, first["checkpoint_records"]
                             + rest["checkpoint_records"])
    d_loss = max(abs(a - b) for a, b in zip(rest["losses"],
                                            full["losses"][3:]))
    d_w = torch.cat([(a - b).abs().flatten() for a, b in zip(
        tree_leaves(rest["opt_state"]["master"]),
        tree_leaves(full["opt_state"]["master"]))])
    frac = float((d_w > RESUME_W_TOL).float().mean())
    bitwise = d_loss == 0 and float(d_w.max()) == 0
    print(f"[{tag}] resumed at step {rest['start_step']}: losses "
          f"{rest['losses']} against {full['losses'][3:]} (max |d| "
          f"{d_loss:.3e}, tol {RESUME_LOSS_TOL:g}); fp32 masters max |d| "
          f"{float(d_w.max()):.3e}, share beyond {RESUME_W_TOL:g} "
          f"{frac:.2e} (tol {RESUME_W_FRAC:g}){'; bitwise' if bitwise else ''}")
    per = expected_single_launches(tc.model, m)
    want = {k: 5 * n for k, n in per.items()}
    print(f"[{tag}] launches {launches} (3 + 2 steps, derived: {want})")
    if rest["start_step"] != 3 or len(rest["losses"]) != 2:
        fail(f"{tag}: the second call started at {rest['start_step']} and "
             f"ran {len(rest['losses'])} steps")
    if not (d_loss <= RESUME_LOSS_TOL and frac <= RESUME_W_FRAC
            and float(d_w.max()) <= 2 * tc.optimizer.lr * 2):
        fail(f"{tag}: resumed run left the uninterrupted one")
    if launches != want:
        fail(f"{tag}: kernel launches {launches} != expected {want}")
    del full, first, rest, d_w
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def print_ptxas(log: str) -> None:
    """One line per kernel of ``nvcc -Xptxas -v``'s log: registers,
    static shared memory, spill stores and loads (the flash kernel's
    K/V ring is dynamic shared memory: 512 * D bytes)."""
    import re
    name, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            try:
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True).stdout.strip() or name
            except OSError:
                pass
            name = re.sub(r"\(.*", "", name.replace("(anonymous namespace)::",
                                                     ""))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            print(f"[build] {name}: {line.split(':', 1)[1].strip()}; {spill}")
            name, spill = None, ""


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    path = build.build()
    how = "built by nvcc" if build.build_seconds is not None \
        else "already built"
    print(f"[build] {os.path.relpath(path, HERE)} {how}, "
          f"{time.perf_counter() - t0:.1f}s")
    log = build.BUILD_DIR / "build.log"
    if log.exists():
        print_ptxas(log.read_text())
    build.load_library()
    done("card and build")

    # 3. kernels vs plain at the serving shapes; fused AdamW; gradients
    #    through the kernel Functions; the chunk body's kernels timed at
    #    the training shapes; the SSD scan at four shapes, its gradients,
    #    rmsnorm at mamba2's shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [phase_rmsnorm(torch, gen), phase_flash(torch, gen),
            phase_adamw(torch, gen), phase_ssd(torch, gen)]
    by_name = {r["name"]: r for r in rows}
    phase_functions(torch, gen)
    phase_train_shapes(torch, gen, by_name)
    phase_flash_d256(torch, gen, by_name)
    phase_rmsnorm_widths(torch, gen)
    phase_flash_offsets(torch, gen, by_name)
    phase_flash_offsets(torch, gen, by_name, H=32, G=32, d=128, n_seqs=(4,),
                        key="train_planner_deepseek")
    phase_deepseek_rmsnorm(torch, gen, by_name)
    phase_ssd_grads(torch, gen)
    phase_ssd_h0(torch, gen, by_name)
    phase_mamba_shapes(torch, gen, by_name)
    torch.cuda.empty_cache()
    done("kernels against their plain versions")

    # 4. serve at full width through the CLI's main(), then a profiled
    #    second run on the same engine
    launches = {}
    launches["serve_tinyllama"], eng, _ = phase_serve(torch)
    phase_profile(torch, eng)
    del eng
    done("serve")

    # 5. serve checks
    phase_checks(torch)
    torch.cuda.empty_cache()
    done("serve checks")

    # 5a-5b. serve mamba2-2.7b (every prefill scan on the SSD kernel from
    #     the slot's carried state) and qwen2-moe-a2.7b at full width,
    #     each with phase 4's gates, a profiled re-run and phase 5's checks
    phase_serve_family(torch, serve_argv("mamba2-2.7b", 128, 2, 256),
                       "serve-mamba2", launches, "serve_mamba2")
    done("serve mamba2-2.7b")
    phase_serve_family(torch, serve_argv("qwen2-moe-a2.7b"),
                       "serve-qwen2-moe", launches, "serve_qwen2_moe")
    done("serve qwen2-moe-a2.7b")

    # 6. train tinyllama at full width through train_pipeline, then a
    #    profiled step; 7. its train checks
    bwd_ms = {
        "attn": by_name["flash_attention_fwd"]["train"]["plain_bwd_ms"],
        "mamba": by_name["ssd_scan"]["plain_bwd_ms"],
        **{("attn", Sc): ms for Sc, ms in by_name["flash_attention_fwd"][
            "train_offsets_plain_bwd_ms"].items()}}
    base = {"tinyllama-1.1b": phase_train(torch, "tinyllama-1.1b", "train",
                                          bwd_ms)}
    launches["train_tinyllama"] = base["tinyllama-1.1b"]["launches"]
    done("train tinyllama-1.1b")
    phase_train_checks(torch, "tinyllama-1.1b", "train-check")
    done("train checks tinyllama-1.1b")

    # 8. train mamba2 at full width, 16 layers (all of tinyllama's
    #    tensors freed first), then a profiled step; 9. its train checks
    gc.collect()
    torch.cuda.empty_cache()
    base["mamba2-2.7b"] = phase_train(torch, "mamba2-2.7b", "train-mamba2",
                                      bwd_ms, layers=MAMBA2_TRAIN_LAYERS)
    launches["train_mamba2"] = base["mamba2-2.7b"]["launches"]
    done("train mamba2-2.7b")
    phase_train_checks(torch, "mamba2-2.7b", "train-check-mamba2")
    done("train checks mamba2-2.7b")

    # 10. train() at full width under Chronos-Recomp (tinyllama in three
    #     recompute modes, mamba2 in chronos), after freeing the earlier
    #     phases' tensors; then the fp32 remat checks
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_train_single(torch))
    phase_train_single_checks(torch)
    done("train-single checks")

    # 11. pipeline training with Chronos-Offload (the deep chunk's AdamW
    #     on the host) at full width, held against phases 6 and 8; then
    #     the fp32 offload-vs-device checks
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_train_offload(torch, base))
    phase_train_offload_checks(torch)
    done("train-offload checks")

    # 12-14. tinyllama-1.1b at full width with the V-shape (v_min) and
    #     sequence-chunked (chronos_seq, seq1f1b) schedules; 15. their
    #     fp32 checks
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_train_schedules(torch, bwd_ms, base))
    phase_train_schedule_checks(torch)
    done("train-schedule checks")

    # 15a. qwen2-moe-a2.7b at full width, 4 layers, chronos_zb on P=2
    #     virtual stages (v=2): the MoE aux sum in the payload, gated as
    #     phase 6, with its router statistics
    gc.collect()
    torch.cuda.empty_cache()
    launches["train_qwen2_moe"] = phase_train(
        torch, "qwen2-moe-a2.7b", "train-qwen2-moe", None, P=2, layers=4,
        inspect=lambda tc, spec, out: moe_router_stats(torch, tc, spec,
                                                       out))["launches"]
    done("train qwen2-moe-a2.7b")
    gc.collect()
    torch.cuda.empty_cache()
    phase_moe_checks(torch, "train-check-qwen2-moe")
    done("MoE checks qwen2-moe-a2.7b")

    # 16. the memory-budget planner's picks trained at full width, and
    #     its predicted peaks against the measured ones (phases 6-15a)
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_train_planner(torch))
    done("train-planner checks")

    # 17. gemma3-27b served at full width (its 52 windowed layers past the
    #     window), 17a. its checks; 18. paligemma-3b trained at full width
    #     through the head-dim-256 kernel with its patch prefix, then its
    #     single-host prefill and decode; 19. whisper-base likewise with
    #     the encoder in the first chunk; 20. their fp32 pipeline checks
    launches["serve_gemma3"] = phase_serve_gemma3(torch)
    done("serve gemma3-27b")
    phase_gemma3_checks(torch)
    done("serve checks gemma3-27b")
    launches["train_paligemma"] = phase_train_a4(
        torch, "paligemma-3b", "train-paligemma", P=3,
        seq=TRAIN_SEQ)["launches"]
    launches["single_paligemma"] = single_host_stream(
        torch, "paligemma-3b", "single-paligemma", prompt_len=64)
    done("train paligemma-3b")
    launches["train_whisper"] = phase_train_a4(
        torch, "whisper-base", "train-whisper", P=3, seq=449)["launches"]
    launches["single_whisper"] = single_host_stream(
        torch, "whisper-base", "single-whisper", prompt_len=32)
    done("train whisper-base")
    phase_a4_checks(torch)
    done("A.4 checks")

    # 21. the elastic drill: tinyllama-1.1b at full width over 8 layers on
    #     P=4 virtual stages through a checkpoint-writer crash, a lost
    #     stage (P=3) and its return (P=4), against the uninterrupted run;
    #     22. train() resumed from its checkpoint against an uninterrupted
    #     train()
    gc.collect()
    torch.cuda.empty_cache()
    launches["train_elastic"] = phase_train_elastic(torch)
    done("train-elastic")
    launches["train_resume"] = phase_train_resume(torch)
    done("train-resume")

    # 23. kernels line, then the result line.  ``launches`` sums the
    #     kernel's launches in the main-path runs (each counted from 0
    #     right before its run), split by path in ``launches_by_path``;
    #     launches made to compare a kernel with its plain version are in
    #     none of them.
    for row in rows:
        row["launches_by_path"] = {path: n.get(row["name"], 0)
                                   for path, n in launches.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
