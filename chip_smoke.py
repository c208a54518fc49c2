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
   and 8-16 new ones: every prefill scan runs the SSD kernel from the
   slot's carried fp32 state (launches 64 x the prefill chunks, no call
   of the plain ``ssd_chunked_ref``), gated as phase 4, with phase 5's
   checks at 128-token chunks;
5b. serve-qwen2-moe: full-width qwen2-moe-a2.7b (60 routed experts top
   4 plus 4 shared, MHA 16 x 128) with phase 4's traffic (8-16 new
   tokens) and gates, the decode tick's weight-read bound beside its
   per-token time, and phase 5's checks;
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
8. train mamba2-2.7b at full width, cut to 8 of its 64 layers, as
   phase 6 does tinyllama (the SSD scan, rmsnorm and fused-AdamW
   kernels), after freeing tinyllama's tensors, then a profiled step;
9. phase 7's checks on mamba2-2.7b (4 layers, two SSD chunks);
10. train-single: full-width tinyllama-1.1b through ``repro_torch.launch.
    train.train`` (8 sequences of 2049 tokens in 2 microbatches, 1 step)
    with the recompute modes none, chronos and full, a profiled chronos
    step, then mamba2-2.7b cut to 8 layers in chronos (8 microbatches of
    one sequence);
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
    Eq. (5)/(7) report; then fp32, 4 layers, 2 steps with the gradient
    clip off: offload against the on-device optimizer (|d loss| <= 5e-3)
    and against the on-device optimizer with its deep weights rounded
    to bf16 after every step (<= 1e-4); with the clip on, printed only;
12. train-vshape: phase 6's run, cut to 8 layers, with ``v_min`` (the
    V-shape fold-back: device d holds blocks d and 7-d; split backward,
    fused AdamW);
13. train-seq-chronos: phase 6's run, cut to 8 layers, with
    ``chronos_seq``, n_seq=2 (two 1024-position chunks per sequence,
    KV-carry and dKV rings) and ``RecomputeConfig("chronos",
    num_recomp_chunks=1)``;
14. train-seq-1f1b: phase 6's run, cut to 4 layers, with ``seq1f1b``,
    v=1, n_seq=4;
    phases 12-14 (2 steps each) check what phase 6 checks (launch counts
    from the table: a sequence-chunked op runs each layer's flash at its
    chunk's offset) and print step time, tokens/s, peak memory and the table's
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
    pick for tinyllama-1.1b trained 1 step as phase 6; (b) deepseek-7b's
    width: ``max_trainable_layers`` of ``1f1b`` and of the best point,
    then the pick for that depth trained at 8 layers, 1 step (``ep.m``
    sequences of 2049 tokens), both gated as phase 6 (finite losses, moved masters,
    launch counts from the table); (c) for every pipeline training run
    of phases 6-16 (15a included) the planner's per-stage total, the
    one-card prediction with its terms and the measured peak (printed,
    not gated);
17. serve-gemma3: full-width gemma3-27b (62 layers, 52 of them with a
    1024-token sliding window; 27.0 B parameters, 54.0 GB bf16) through
    ``launch.serve.main``: P=1, 4 slots, 128-token chunks, prompts of 1
    to 12 chunks (at least two past the window), 8-16 new tokens,
    gated as phase 4; the peak beside its reckoning (the copying pack
    frees each LM leaf as it packs it: weights plus one block leaf), the
    decode tick's bound; 17a. reduced gemma3 in
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
23. serve-resilient: full-width tinyllama-1.1b (22 layers, bf16, 4
    slots, 64-token chunks, phase 4's 8 requests at once): the engine at
    P=1 (the stream oracle), ``serve_resilient`` at P=3 without faults
    (and the bare P=3 engine, for the monitor's cost), then at P=3
    through a slot corruption, a straggler window, a lost stage slot and
    a hung tick: P 3 -> 2 -> 1, every stream the oracle's, two recovery
    records with their phase seconds, the retries, the injector's events,
    the window's checkpoint_now then restart, no non-finite logits on an
    accepted wave, launches derived from each engine's injections, the
    peak across the recoveries; then the CLI at P=2 with bursty
    arrivals, deadlines and a queue bound: one terminal state each, no
    slot left occupied, completed streams equal to a P=1 run's;
24. serve-batched: ``--pipelined 0`` through the CLI, batch 4 x 512
    prompt tokens, 32 new, greedy: flash once per layer in the prefill,
    rmsnorm twice per layer per call, finite logits; prefill and decode
    times beside the weight-read bound, cold and warm; fp32 2-layer fused
    vs plain logits within 1e-3;
25. train-wire: phase 6's run with the compressed boundary wire and
    shared-gradient sum (``ParallelPlan.wire``, ``grad_compression``):
    25a ``wire="bf16"`` (at bf16 compute the exact wire: losses and
    gradient norms bitwise phase 6's, its launches); 25b ``wire="int8"``
    with ``grad_compression="int8_ef"`` (int8 codes and a per-row fp32
    scale in the rings, the shared gradients summed over the stages on
    an int8 grid with error feedback): the rings' bytes, 25a's and
    25b's each equal to the reckoning from the task table, every leaf's
    ``ef_abs_max`` within half its grid step, moved masters, phase 6's
    launches, loss_4 within 0.03 of phase 6's (25b 4 steps, 25a and 25c
    2 each); 25c phase 11's offload
    run with ``int8_ef`` (the deep
    gradients shipped as int8 codes and scales, dequantized on the host):
    phase 11's launches, its peak plus the EF's 0.524 GB plus 0.1 GiB at
    most, the shipped bytes, copy GB/s and ``collect_wait_s`` beside
    phase 11's; 25d the reduced tinyllama in fp32, wire bf16 and int8
    with int8_ef, 3 steps: gradients, loss and EF on the card against
    the CPU (each wire its own tolerances, the shared gradients and EF in
    codes of their scale), and the int8 wire's codes, scales and
    read-back for a 2048 x
    2048 bf16 payload and ``compressed_sum`` bitwise the CPU's;
26. roofline: one more (untimed) step of phases 6, 8, 10 (none,
    chronos, full) and 15a, counted on the card by
    ``repro_torch.roofline.count_work`` right after each phase's timed
    steps (no model is rebuilt), against the dry run of the same
    configuration and plan on the meta device
    (``repro_torch.launch.dryrun``, counted by a child process that
    phase 6 starts: it needs no card): the configurations equal, the
    FLOPs and every kernel's ``kernel_cost`` sums equal exactly; each
    printed with the bytes
    moved (score-class apart), ``model_flops_for``, ``useful_ratio``,
    the three roofline terms on H100 peaks, the dominant one and ``mfu``
    against the phase's median step, beside the card's name and power
    limit; and phase 4's decode tick counted there, its bytes at least
    the weights ``decode_bound_ms`` reads;
27. train-ranks: phase 6's configuration cut to 8 layers
    (``RANKS_LAYERS``) trained as four processes on the card, one
    pipeline stage each (``repro_torch.launch.mesh.spawn``,
    gloo through page-locked host memory: NCCL refuses two ranks on one
    device, and that refusal is checked first), 2 steps with the
    overlapped exchange and 1 with the synchronous one, each rank's
    launches summed into ``train_ranks``; finite losses equal on every
    rank, shared replicas equal after every step, the summed launches
    the table's; each rank's step time, peak beside ``MemoryModel``'s
    stage prediction, bytes moved beside the dry run's and its share of
    waits on the exchange, and the two step times beside
    ``comm_calibration`` scaled by the synchronous step (printed, not
    gated); then the fp32 check at 4 layers: every rank's gradients
    bitwise the one-device executor's;
28. train-mesh: full-width tinyllama-1.1b cut to 4 layers, chronos_zb
    P=2 v=2, m=4, one 2049-token sequence a dp rank a microbatch, on a
    pp 2 x dp 2 x tp 2 mesh of eight processes on the card
    (``spawn(shape=)``, gloo through page-locked host memory): heads,
    FFN and vocab split over tp, the batch over dp, the blocks'
    optimizer state over dp (ZeRO-1), 2 steps; finite losses equal on
    every rank, the dp replicas and the tp-replicated leaves bitwise
    equal after every step, the summed launches the table's x dp x tp
    (fused AdamW one a leaf slice a rank), the bytes handed to
    collectives each step ``collective_stats``' count axis by axis; each
    rank's step, peak beside ``MemoryModel``'s stage at (pp 2, tp 2),
    bytes by axis and exchange wait share; then the fp32 check at 4
    layers (m=2, 257 tokens): every rank's gradient shard within 2e-5
    relative of the one-process executor's;
29. train-zero3 and train-single-mesh, in phase 28's processes: the same
    at ZeRO stage 3, then ``train()`` on them regrouped as pp 1 x dp 4 x
    tp 2 at stages 3 and 1, each with its fp32 check;
30. train-families, in the same processes: mamba2-2.7b at full width cut
    to 4 layers (the Mamba-2 channels and heads over tp, the gated
    norm's rows across the ranks on the split-width RMSNorm pair) and
    qwen2-moe-a2.7b at full width, 2 layers, half its vocabulary (the
    experts' hidden width over tp, the routing over the global
    microbatch), on pp 2 x dp 2 x tp 2, 2 steps each, gated as phase 28
    (for qwen2-moe also every F op's dropped fraction in its fp32 check,
    equal on all ranks and to the one-process run's); then ``train()``
    of each on pp 1 x dp 4 x tp 2 at stage 1, one step and its fp32
    check;
31. train-encvlm, in the same processes, gated as phase 30:
    whisper-base at full width and depth (its encoder over tp, the
    cross-attention's encoder input summed over tp backward, its odd
    51865-row table and head whole on every tp rank), v=1, 449-token
    sequences with their 1500 frames, on pp 2 x dp 2 x tp 2, and
    paligemma-3b at full width, 4 layers and its whole vocabulary on the
    processes regrouped as pp 2 x dp 1 x tp 4 (its one K/V head on the
    four tp ranks of its K/V group: their copies bitwise equal after
    every step, their gradient summed over them), 2 steps each and their
    fp32 checks; then ``train()`` of each on pp 1 x dp 4 x tp 2
    (paligemma at 2 layers), one step and its fp32 check;
32. a JSON ``kernels`` line, then the JSON result line.

Every bound phase 3 prints is ``repro_torch.roofline.kernel_cost``'s
work of the kernel's function over the H100's peaks (``kernel_bound``).
Phase 3 also runs flash at the shapes of phases 17-19 (head dim 256
with paligemma's prefix: its training shape, prefill chunks at offsets,
B=2 ragged, H == G on both CTAs; whisper's non-causal encoder and causal
decoder; gemma3's prefill chunks past the window), printing each bf16
case's CTA shape, and times the head-dim-256 kernel at paligemma's
training shape beside its bound, the plain version and SDPA with the
boolean prefix-LM mask, with the Function's gradients there; and flash
at a tp=2 rank's heads of the training shape (phase 28's: q
[1,2048,16,64] over kv [1,2048,2,64]) in fp32 and bf16, timed beside
the plain version, SDPA and the bound, and at phase 31's rank shapes (a
tp 4 paligemma rank's q [1,2304,2,256] over its one K/V head, prefix
256; a tp 2 whisper encoder rank's q = kv [1,1500,4,64], non-causal),
bf16, timed likewise; and the split-width RMSNorm pair
(``rmsnorm_sumsq_rows``, ``rmsnorm_scale_rows``) against its plain
versions and, over two column halves, against ``rmsnorm_rows`` on the
whole rows, timed at a tp 2 rank's [2049, 2560] in bf16 and fp32 beside
``rmsnorm_rows`` at the whole [2049, 5120], with the SSD scan at a tp 2
rank's 40 heads.
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

Each phase prints a ``[time]`` line.  On an NVIDIA H100 80GB HBM3 at
700.00 W the run before phase 28 took 811.8 s of its 1200 s limit on a
fast host, and 1062.4 s on a slow one where the tree before phase 27
took 1117.6 s: phase 27 took 67.8-98.8 s, 23-39 s of it the four fresh
processes' first step, and fewer steps in phases 10-11 (3), 12-14 (2),
25a and 25c (2) and phase 14 at 4 layers pay for it.  Phase 28 took
50.7 s alone (eight fresh processes' first step ~16 s, then ~4.1 s a
step, the fp32 check) and phase 3's tp=2 flash case ~2 s; phase 16b at
8 layers (16 before: its two steps took 40.8 s), phase 16a's 3 steps
(4 before, ~5.6 s a step) and phase 10's 2 (3 before, ~2.8 s a step)
pay for them.  Phases 28-30 took 197.8 s on a fast host and 262.8 s on
a slow one, where the whole run took 1001.2 s and 1206.4 s: to keep a
slow host inside the limit, mamba2's phases 8, 10 and 11 run 8 layers
(16 before), and phases 10, 16a, 16b, 29 (A) and 27's synchronous
run one step, phases 11 (and its fp32 checks) and 27's overlapped run
two, phase 29 (B)'s stage 3 one.  Phase 31 added ~80 s on a fast host
(the whole run 790.4 s there): phase 27 runs 8 of its 22 layers to pay
for it.  Host speed moves the host-paced phases by up to ~45%.

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


def warm_median(step_s) -> float:
    """The median of a run's step times after its first (a warm-up), or
    its one step where it ran one."""
    return statistics.median(step_s[1:] or step_s)


def median_word(step_s) -> str:
    """What :func:`warm_median` of ``step_s`` is: the median of the warm
    steps, or the one step of a one-step run, which is cold (it carries
    the run's first-call costs) and not comparable with a median."""
    return "median step" if len(step_s) > 1 else "one cold step"


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


def kernel_bound(name: str, peak: str = "bf16", **shapes):
    """``(ms, "bytes" | "operations", flops, bytes)``: the least time the
    card takes for one call of kernel ``name`` at ``shapes``, from
    ``repro_torch.roofline.kernel_cost`` (the work of the function) over
    the H100's memory rate and its ``peak`` ("bf16" tensor cores or
    "fp32")."""
    from repro_torch.roofline.analysis import (PEAK_FLOPS, PEAK_FLOPS_FP32,
                                               bound_ms, kernel_cost)
    flops, nbytes = kernel_cost(name, **shapes)
    ms, by = bound_ms(flops, nbytes,
                      PEAK_FLOPS if peak == "bf16" else PEAK_FLOPS_FP32)
    return ms, by, flops, nbytes


def hbm_ms(nbytes: float) -> float:
    """``nbytes`` read once at the H100's memory rate, in ms."""
    from repro_torch.roofline.analysis import HBM_BW
    return nbytes / HBM_BW * 1e3


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
    b_ms, bound_by, _, _ = kernel_bound("rmsnorm_rows", R=R, d=d,
                                        itemsize=x.element_size())
    print(f"[kernels] rmsnorm_rows timed at x [{R}, {d}] bf16 (device time "
          f"per call) {rmsnorm_line(t)}; eager call-to-call "
          f"{eager_ms * 1e3:.2f} us; bound {b_ms * 1e3:.4f} us "
          f"({bound_by}, kernel_cost)")
    return {"name": "rmsnorm_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:18",
            "max_abs_err": worst, **t,
            "bound_ms": b_ms, "bound_by": bound_by,
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
             (1, TRAIN_SEQ - 1, 16, TRAIN_SEQ - 1, 16, 128, 0, 0, 0),
             # single-host batched serving's prefill (phase 24): 4 prompts
             # of 512 tokens over the 544-slot cache (512 + 32 new)
             (4, 512, 32, 544, 4, 64, 0, 0, 0)]
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
    from repro_torch.roofline.analysis import visible_pairs
    pairs, k_rows = visible_pairs(Sq, Sk, q_offset=off)
    b_ms, bound_by, _, _ = kernel_bound(
        "flash_attention_fwd", B=1, Sq=Sq, Sk=Sk, H=H, G=G, d=d,
        itemsize=q.element_size(), q_offset=off)
    print(f"[kernels] flash_attention_fwd timed at q [1,{Sq},{H},{d}] kv "
          f"[1,{Sk},{G},{d}] bf16 q_offset={off} (device time per call, "
          f"CUDA graph): kernel {ms * 1e3:.2f} us (eager call-to-call "
          f"{eager_ms * 1e3:.2f} us), "
          f"plain {plain_ms * 1e3:.2f} us, SDPA {lib_ms * 1e3:.2f} us, "
          f"bound {b_ms * 1e3:.4f} us ({bound_by}, kernel_cost; {pairs} "
          f"visible pairs per head, {k_rows} kv rows)")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:98",
            "max_abs_err": worst, "lse_max_abs_err": worst_lse, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms,
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


# new tokens a request of the family serves (phases 5a, 5b and 17): half
# of phase 4's 16-32, as their decode ticks take 3x phase 4's
FAMILY_GEN = (8, 16)


def serve_argv(arch: str, chunk: int = 64, prompt_chunks: int = 4,
               prompt_len: int = 224):
    """Phase 4's traffic for ``arch`` with ``FAMILY_GEN`` new tokens: 8
    requests at once, 4 slots, prompts of 1 to ``prompt_chunks`` chunks
    of ``chunk`` tokens, greedy, full width, fused kernels; the defaults
    are phase 4's own."""
    argv = list(SERVE_ARGV)
    for flag, val in (("--arch", arch), ("--chunk", str(chunk)),
                      ("--prompt-len", str(prompt_len)),
                      ("--gen-min", str(FAMILY_GEN[0])),
                      ("--gen", str(FAMILY_GEN[1]))):
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
    return nbytes, hbm_ms(nbytes)


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
    if res["nonfinite_logits"] or res["stale_nonfinite_logits"]:
        fail(f"sampled waves had non-finite logits: accepted "
             f"{res['nonfinite_logits']}, stale "
             f"{res['stale_nonfinite_logits']}")
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


def _device_rows(prof) -> list:
    """(kernel name, records, device us) of each kernel name in a closed
    ``torch.profiler.profile`` session: the device rows of its
    ``key_averages()`` (a kernel's self time is its duration), summed
    from the raw kineto records.  ``key_averages()`` first builds an
    event object for every record and links the runtime calls to their
    kernels, which took 8-21 s a training step on the card's host; this
    reads the same records without them."""
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA") or e.is_async() \
                or getattr(e, "is_hidden_event", lambda: False)():
            continue                  # runtime calls; their kernels count
        r = rows.setdefault(e.name(), [0, 0.0])
        r[0] += 1
        r[1] += e.duration_ns() / 1e3
    return [(k, n, us) for k, (n, us) in rows.items()]


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
    for key, count, dev in _device_rows(prof):
        if dev <= 0:
            continue
        rows.append((dev, count, key))
        name = key.lower()
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
    ``launches[key]``; then phase 5's checks on the same architecture and
    chunk.  (Its warm profiled re-run went for the smoke's time limit:
    phase 4's stays.)"""
    gc.collect()
    torch.cuda.empty_cache()
    launches[key], eng, _ = phase_serve(torch, argv, tag)
    arch, chunk = eng.cfg.name, eng.chunk
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

TRAIN_SEQ = 2049               # 2048 positions per sequence fed to the stack
# mamba2-2.7b's pipeline runs (phases 8 and 11) and train() (10) at full
# width, cut to 8 of its 64 layers (16 before phase 30 needed the time)
# so that the whole smoke keeps inside its time limit on a slow host (an
# H100 run took 1064.5 s with 32)
MAMBA2_TRAIN_LAYERS = 8
# deepseek-7b's planner pick (phase 16b), planned for the largest depth
# that fits a quarter of the card (24 layers) and trained at 8 (16
# before phase 28 needed the time): its 2 host-paced steps took 68 s at
# 24 layers on a slow host, 40.8 s at 16 on a fast one
DEEPSEEK_TRAIN_LAYERS = 8
# its steps (2 before phase 30 needed the time: one host-paced step of a
# fresh model, untimed warm)
DEEPSEEK_STEPS = 1
# steps of phase 16a, tinyllama-1.1b's planner pick (4 before phase 28, 3
# before phase 30)
PLANNER_STEPS = 1
# the sequence-chunked runs (phases 13-14) at full width, cut to 8 of
# tinyllama-1.1b's 22 layers: their host-paced steps and long traces
# (seq1f1b: 84.2 s at 22 layers) made room for phases 21-22
SEQ_TRAIN_LAYERS = 8
# steps of phases 12-14 (4 before phase 27 needed the time; the first
# warms up, the second is timed), and phase 14's depth (8 before): at
# v=1 a block holds L_pad / 4 layers, so 4 layers halve its host-paced
# step, where the v=2 schedules of phases 12-13 would only pad 4 layers
# back to 8
SCHEDULE_STEPS = 2
SEQ1F1B_LAYERS = 4
# steps of phases 10 and 11 (4 before phase 27; a cut past the phases
# 12-14 and 25 that phase 27's time was to come from; phase 10's 2 since
# phase 28 and 1 since phase 30, phase 11's 2 since phase 30: the first
# warms up, the second is timed)
SINGLE_STEPS = 1
OFFLOAD_STEPS = 2
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
    b_ms, bound_by, _, nbytes = kernel_bound(
        "fused_adamw_flat", peak="fp32", n=n, g_itemsize=g.element_size())
    print(f"[kernels] fused_adamw_flat timed at n={n} (wi leaf) fp32 g "
          f"(device time per call, CUDA events): kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({bound_by}, kernel_cost; "
          f"{nbytes / 1e9:.2f} GB) = {ms / b_ms:.2f}x bound; "
          f"no one-call PyTorch yardstick (torch._fused_adamw_ divides "
          f"sqrt(nu) by sqrt(bc2) before adding eps and decays w as "
          f"w*(1-lr*wd): another function)")
    del g, mu, nu, w
    torch.cuda.empty_cache()
    return {"name": "fused_adamw_flat", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_adamw.cu",
            "replaces": "src/repro/kernels/fused_adamw/kernel.py:32",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": bound_by,
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
    fb_ms, fby, flops, _ = kernel_bound(
        "flash_attention_fwd", B=1, Sq=S, Sk=S, H=H, G=G, d=d,
        itemsize=q.element_size())
    print(f"[kernels] flash_attention_fwd timed at the training shape q "
          f"[1,{S},{H},{d}] kv [1,{S},{G},{d}] bf16 q_offset=0 (CUDA events):"
          f" kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s achieved), "
          f"plain {plain_ms:.3f} ms, SDPA (is_causal, GQA) {lib_ms:.3f} ms "
          f"({flops / lib_ms / 1e9:.1f} TFLOP/s; kernel = "
          f"{ms / lib_ms:.2f}x SDPA), bound {fb_ms * 1e3:.2f} us ({fby}, "
          f"kernel_cost; {flops / 1e9:.2f} GFLOP) = {ms / fb_ms:.1f}x "
          f"bound")
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
        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": fb_ms,
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
    rb_ms, rby, _, _ = kernel_bound("rmsnorm_rows", R=S, d=2048,
                                    itemsize=x.element_size())
    print(f"[kernels] rmsnorm_rows timed at the training shape x [{S},2048] "
          f"bf16 {rmsnorm_line(t)}; bound {rb_ms * 1e3:.3f} us ({rby}, "
          f"kernel_cost)")
    rows["rmsnorm_rows"]["train"] = {
        "max_abs_err": e_r, **t, "bound_ms": rb_ms, "bound_by": rby,
        "timed_shape": f"x [{S},2048] bf16"}


def phase_flash_tp(torch, gen, rows, H=16, G=2, d=64):
    """Flash at a tp=2 rank's heads of the training shape (phase 28's):
    q [1,2048,16,64] over kv [1,2048,2,64], fp32 and bf16, held against
    the plain version at phase 3's tolerances and timed beside it, SDPA
    and the bound (bf16 in the kernels line's row, fp32 beside it)."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    import torch.nn.functional as F
    S = TRAIN_SEQ - 1
    tols = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-2, 1e-5)}
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((1, S, H, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((1, S, G, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((1, S, G, d), generator=gen, device="cuda").to(dt)
        o, lse = flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention_ref(q, k, v)
        e_o, e_l = max_err(o, o_ref), max_err(lse, lse_ref)
        t_o, t_l = tols[dt]
        ok = e_o <= t_o and e_l <= t_l
        name = str(dt)[6:]
        print(f"[kernels] flash_attention_fwd {name} q [1,{S},{H},{d}] kv "
              f"[1,{S},{G},{d}] (a tp=2 rank's heads, phase 28): max|d| "
              f"o={e_o:.3e} (tol {t_o:g}) lse={e_l:.3e} (tol {t_l:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("flash_attention_fwd disagrees with attention_ref at the "
                 "tp=2 training shape")
        del o, lse, o_ref, lse_ref
        ms = time_ms(lambda: flash_attention_fwd(q, k, v), iters=20,
                     warmup=3)
        plain_ms = time_ms(lambda: attention_ref(q, k, v), iters=5, warmup=1)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=20, warmup=3)
        b_ms, by, flops, _ = kernel_bound(
            "flash_attention_fwd", peak="bf16" if dt == torch.bfloat16
            else "fp32", B=1, Sq=S, Sk=S, H=H, G=G, d=d,
            itemsize=q.element_size())
        print(f"[kernels] flash_attention_fwd {name} timed at the tp=2 "
              f"shape (CUDA events): kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, SDPA (is_causal, GQA) {lib_ms:.3f} ms "
              f"(kernel = {ms / lib_ms:.2f}x SDPA), bound {b_ms * 1e3:.2f} "
              f"us ({by}; {flops / 1e9:.2f} GFLOP) = {ms / b_ms:.1f}x bound")
        out[name] = {"max_abs_err": e_o, "lse_max_abs_err": e_l, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": by,
                     "timed_shape": f"q [1,{S},{H},{d}] kv [1,{S},{G},{d}] "
                                    f"{name}"}
        del q, k, v, qt, kt, vt
    rows["flash_attention_fwd"]["train_tp2"] = out


PALI_PREFIX = 256               # paligemma-3b's patches


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
    from repro_torch.roofline.analysis import visible_pairs
    pairs = visible_pairs(S, S, prefix=pre)[0]
    b_ms, by, flops, nbytes = kernel_bound(
        "flash_attention_fwd", B=1, Sq=S, Sk=S, H=H, G=G, d=d,
        itemsize=q.element_size(), prefix=pre)
    print(f"[kernels] flash_attention_fwd at head dim 256, paligemma's "
          f"training shape q [1,{S},{H},{d}] kv [1,{S},{G},{d}] bf16 prefix="
          f"{pre} [flash_fwd_kernel_mma<256,4>: {cta_desc(256, 4)}]: max|d| "
          f"o={e_o:.3e} lse={e_l:.3e}; device time per call (CUDA graph): "
          f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms, SDPA (boolean prefix-LM mask) {lib_ms:.4f} ms"
          f" (kernel = {ms / lib_ms:.2f}x SDPA), bound {b_ms * 1e3:.2f} us "
          f"({by}, kernel_cost; {pairs} visible pairs a head, "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) = "
          f"{ms / b_ms:.1f}x bound")
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
        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
        "bound_by": by, "plain_bwd_ms": bwd_ms,
        "timed_shape": f"q [1,{S},{H},{d}] kv [1,{S},{G},{d}] bf16 "
                       f"prefix={pre}"}
    # the Function's gradients at D=256 with the prefix, both dtypes
    for gdt, tol_o, tol_g in ((torch.float32, 2e-5, 1e-5),
                              (torch.bfloat16, 2e-2, 1e-2)):
        _flash_grad_case(torch, gen, gdt, 512, tol_o, tol_g, H=8, G=1,
                         d=256, prefix=64)


# phase 31's ranks, bf16: (q heads, K/V heads, head dim, positions, mask)
FLASH_ENCVLM = {
    # a tp 4 rank of paligemma-3b: 2 of its 8 query heads over its one
    # K/V head, the 256 patches a bidirectional prefix
    "train_tp4_d256": (2, 1, 256, PALI_PREFIX + TRAIN_SEQ - 1,
                       dict(prefix=PALI_PREFIX)),
    # a tp 2 rank of whisper-base's encoder: 4 of its 8 heads over the
    # 1500 frames, non-causal
    "train_tp2_encoder": (4, 4, 64, 1500, dict(causal=False)),
}


def phase_flash_encvlm(torch, gen, rows):
    """Flash at phase 31's rank shapes (``FLASH_ENCVLM``, bf16): each held
    against ``attention_ref`` at phase 3's tolerances, timed by
    CUDA-graph replay beside the plain version, SDPA (paligemma's given
    the boolean prefix-LM mask, K/V repeated to the query heads) and the
    bound from ``kernel_cost``."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    import torch.nn.functional as F
    dt = torch.bfloat16
    for key, (H, G, d, S, kw) in FLASH_ENCVLM.items():
        q = torch.randn((1, S, H, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((1, S, G, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((1, S, G, d), generator=gen, device="cuda").to(dt)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention_ref(q, k, v, **kw)
        e_o, e_l = max_err(o, o_ref), max_err(lse, lse_ref)
        ok = e_o <= 2e-2 and e_l <= 1e-5
        shape = f"q [1,{S},{H},{d}] kv [1,{S},{G},{d}] bf16 {kw}"
        print(f"[kernels] flash_attention_fwd at phase 31's {key} shape "
              f"{shape}: max|d| o={e_o:.3e} (tol 2e-2) lse={e_l:.3e} (tol "
              f"1e-5) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_attention_fwd disagrees with attention_ref at "
                 f"{key}")
        del o, lse, o_ref, lse_ref
        ms = graph_ms(lambda: flash_attention_fwd(q, k, v, **kw))
        plain_ms = graph_ms(lambda: attention_ref(q, k, v, **kw), reps=3,
                            iters=3)
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(H // G, dim=2).transpose(1, 2).contiguous()
        pre, causal = kw.get("prefix", 0), kw.get("causal", True)
        if pre:
            pos = torch.arange(S, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) | (pos[None, :] < pre)
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        else:
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
        b_ms, by, flops, nbytes = kernel_bound(
            "flash_attention_fwd", B=1, Sq=S, Sk=S, H=H, G=G, d=d,
            itemsize=q.element_size(), causal=causal, prefix=pre)
        print(f"[kernels] flash_attention_fwd {key} timed (CUDA graph): "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (kernel = "
              f"{ms / lib_ms:.2f}x SDPA), bound {b_ms * 1e3:.2f} us ({by}; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) = "
              f"{ms / b_ms:.1f}x bound")
        rows["flash_attention_fwd"][key] = {
            "max_abs_err": e_o, "lse_max_abs_err": e_l, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": by, "timed_shape": shape}
        del q, k, v, qt, kt, vt


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
            b_ms, by, flops, _ = kernel_bound(
                "flash_attention_fwd", B=1, Sq=Sc, Sk=S, H=H, G=G, d=d,
                itemsize=q.element_size(), q_offset=off)
            shape = (f"q [1,{Sc},{H},{d}] kv [1,{S},{G},{d}] bf16 "
                     f"q_offset={off} (n_seq={ns})")
            print(f"[kernels] flash_attention_fwd {shape}: max|d| o="
                  f"{e_o:.3e} (tol 0.02) lse={e_l:.3e} (tol 1e-05); "
                  f"FlashAttention dq={e_g[0]:.3e} dk={e_g[1]:.3e} dv="
                  f"{e_g[2]:.3e} (tol 0.01), max|dk, dv| past the frontier "
                  f"{past:g} (must be 0) {'ok' if ok else 'FAIL'}; "
                  f"kernel {ms * 1e3:.2f} us (CUDA graph), plain "
                  f"{plain_ms * 1e3:.2f} us, SDPA (boolean mask) "
                  f"{lib_ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us "
                  f"({by}, kernel_cost; {flops / 1e9:.2f} GFLOP) = "
                  f"{ms / b_ms:.1f}x bound")
            if not ok:
                fail(f"flash_attention_fwd / FlashAttention disagree with "
                     f"attention_ref at {shape}")
            out.append({"timed_shape": shape, "max_abs_err": e_o,
                        "lse_max_abs_err": e_l, "grad_max_abs_err": max(e_g),
                        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": b_ms, "bound_by": by})
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
    rb_ms, rby, _, _ = kernel_bound("rmsnorm_rows", R=R, d=D,
                                    itemsize=x.element_size())
    print(f"[kernels] rmsnorm_rows bf16 x [{R},{D}] (deepseek-7b's chunk): "
          f"max|d|={e_r:.3e} tol=1e-06+0.0078125*|ref| "
          f"{'ok' if ok else 'FAIL'}; {rmsnorm_line(t)}; bound "
          f"{rb_ms * 1e3:.3f} us ({rby}, kernel_cost)")
    if not ok:
        fail("rmsnorm_rows disagrees with its plain version at deepseek-7b's "
             "chunk shape")
    rows["rmsnorm_rows"]["train_planner_deepseek"] = {
        "max_abs_err": e_r, **t, "bound_ms": rb_ms, "bound_by": rby,
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


def _ssd_design_bytes(B, S, H, P, N, Q, el):
    """(device-memory bytes, L2 re-reads) of the bf16 route's three
    passes, if nothing stayed in the L2 between them: what the call must
    move plus the state scratch [B, S/Q, H, P, N] fp32 (written by pass a,
    read and written by pass b, read by pass c) and cum; and, apart, the
    chunk's B (pass a) and B and C (pass c) tiles that every head and
    64-column block re-reads, which the L2 serves."""
    from repro_torch.roofline.analysis import kernel_cost
    nc, npb = S // Q, -(-P // 64)
    _, must = kernel_cost("ssd_scan", B=B, S=S, H=H, P=P, N=N, Q=Q,
                          itemsize=el)
    states = B * nc * H * P * N * 4
    cum = B * nc * H * Q * 4
    rereads = 3 * B * nc * H * npb * Q * N * el + 2 * npb * B * S * H * 4
    return must + 4 * states + 2 * cum, rereads


def _ssd_kernel_ms(torch, fn, calls: int = 1, sessions: int = 4) -> dict:
    """Kernel name -> device ms per call of each SSD kernel that ``fn``
    launches, from ``torch.profiler`` over ``calls`` calls after one more
    untraced; the names tell the routes apart (``ROUTE_KERNELS``).  A
    profiler session on the card now and then drops device records (seen
    with torch 2.11, on a 4096^2 matmul as well), all of a kernel's or
    some, in bursts: the SSD kernel that ends a session is missing while
    the kernels before it are recorded, for two or three sessions in a
    row, in every process on the card at once.  So each session stays
    open a moment after the last kernel ends, a session is kept only if
    its kernel names are a whole route's and each kernel has one record
    per wrapper launch in it, and a session that is not is traced again
    after a pause that doubles (0.5 s, 1 s, 2 s), up to ``sessions`` in
    all.  Returns {} if none was whole."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssd_scan import ssd_scan
    fn()
    torch.cuda.synchronize()
    for k in range(sessions):
        if k:
            time.sleep(0.25 * 2 ** k)
        out, seen = {}, {}
        before = ssd_scan.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
        n = ssd_scan.launches - before
        for e in prof.key_averages():
            m = re.search(r"\bssd_scan_kernel\w*", e.key)
            if m:
                dev = getattr(e, "self_device_time_total", None)
                if dev is None:
                    dev = getattr(e, "self_cuda_time_total", 0.0)
                out[m.group(0)] = out.get(m.group(0), 0.0) \
                    + dev / 1e3 / calls
                seen[m.group(0)] = seen.get(m.group(0), 0) + e.count
        if _ssd_route_of(out) != "none" and n > 0 and all(
                c == n for c in seen.values()):
            return out
        print(f"[kernels] the profiler recorded SSD kernels {seen} over "
              f"{n} wrapper launches"
              + (": traced again" if k + 1 < sessions else ""))
    print(f"[kernels] the profiler dropped SSD kernel records in all "
          f"{sessions} sessions")
    return {}


def _ssd_graph_kernels(torch, fn) -> dict:
    """SSD kernel name -> its kernel nodes in a CUDA graph captured from
    one ``fn()`` call: what the wrapper enqueued, as the graph holds it,
    read from the graph's debug dump (mangled names; the kernels sit in
    an anonymous namespace, so a name is matched whole by the digit of
    its length before it and the ``E`` or ``I`` after it)."""
    import tempfile

    from repro_torch.kernels.ssd_scan.ops import ROUTE_KERNELS
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        g.debug_dump(path)
        with open(path) as f:
            text = f.read()
    del g
    names = {k for ks in ROUTE_KERNELS.values() for k in ks}
    found = {k: len(re.findall(rf"\d{re.escape(k)}[EI]", text))
             for k in names}
    return {k: c for k, c in found.items() if c}


def _ssd_route_ran(torch, fn) -> tuple:
    """(route, how it was read) of the SSD kernels one ``fn()`` call
    runs: from the profiler's records, or, where the profiler dropped
    them in every session, from the kernel nodes of a captured graph of
    the same call."""
    ran = _ssd_route_of(_ssd_kernel_ms(torch, fn))
    if ran != "none":
        return ran, "profiler"
    nodes = _ssd_graph_kernels(torch, fn)
    ran = _ssd_route_of(nodes) if all(c == 1 for c in nodes.values()) \
        else "none"
    print(f"[kernels] SSD kernel nodes of the captured call: {nodes}")
    return ran, "graph nodes"


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
            ran, how = _ssd_route_ran(torch, call)
            y_ref, h_ref = ssd_chunked_ref(*ins, Q)
            scale = max(1.0, float(y_ref.abs().max()),
                        float(h_ref.abs().max()))
            e_y, e_h = max_err(y, y_ref), max_err(h, h_ref)
            ok = (y.shape == y_ref.shape and h.shape == h_ref.shape
                  and max(e_y, e_h) <= SSD_TOL * scale)
            print(f"[kernels] ssd_scan ({name}) {str(dtype)[6:]} x [{B},{S},"
                  f"{H},{P}] N={N} Q={Q}, route {ran} ({how}): "
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
    b_ms, bound_by, ops, nbytes = kernel_bound(
        "ssd_scan", B=B, S=S, H=H, P=P, N=N, Q=Q, itemsize=2)
    dram, rereads = _ssd_design_bytes(B, S, H, P, N, Q, 2)
    route = ssd_scan_route(torch.bfloat16)
    print(f"[kernels] ssd_scan timed at x [{B},{S},{H},{P}] bf16, N={N}, "
          f"Q={Q} (CUDA events), route {route}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, the CUDA-core route on the same inputs "
          f"widened to fp32 {was_ms:.3f} ms, bound "
          f"{b_ms * 1e3:.2f} us ({bound_by}, kernel_cost; "
          f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) = "
          f"{ms / b_ms:.1f}x bound; no one-call PyTorch "
          f"yardstick; the SSDScan backward (plain VJP, recomputing "
          f"ssd_chunked_ref) {bwd_ms:.3f} ms")
    print(f"[kernels] ssd_scan design traffic (three passes, a model of "
          f"the shapes, not a measurement): {dram / 1e6:.1f} MB of device "
          f"memory if nothing stays in the L2 "
          f"({hbm_ms(dram) * 1e3:.2f} us at 3.35 TB/s; the "
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
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
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
        ran, how = _ssd_route_ran(
            torch, lambda: ssd_scan(*ins, chunk=Q, h0=h0))
        y_ref, h_ref = ssd_chunked_ref(*ins, Q, h0)
        scale = max(1.0, float(y_ref.abs().max()), float(h_ref.abs().max()))
        e_y, e_h = max_err(y, y_ref), max_err(h, h_ref)
        z = ssd_scan(*ins, chunk=Q, h0=torch.zeros_like(h0))
        n = ssd_scan(*ins, chunk=Q)
        bitwise = torch.equal(z[0], n[0]) and torch.equal(z[1], n[1])
        ok = max(e_y, e_h) <= SSD_TOL * scale
        print(f"[kernels] ssd_scan h0 {str(dtype)[6:]} x [{B},{S},{H},{P}] "
              f"N={N} Q={Q}, route {ran} ({how}): max|d| vs "
              f"ssd_chunked_ref(h0) "
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
    b_ms, by, ops, nbytes = kernel_bound(               # h0 read once
        "ssd_scan", B=B, S=S, H=H, P=P, N=N, Q=Q, itemsize=2, h0=True)
    print(f"[kernels] ssd_scan h0 timed at x [{B},{S},{H},{P}] bf16 "
          f"(device time per call, CUDA graph): kernel {ms * 1e3:.2f} us "
          f"with h0, {ms0 * 1e3:.2f} us without (eager call-to-call "
          f"{eager_ms * 1e3:.2f} us), plain {plain_ms:.3f} ms (CUDA "
          f"events), bound "
          f"{b_ms * 1e3:.2f} us ({by}, kernel_cost; {nbytes / 1e6:.2f} MB, "
          f"{ops / 1e9:.3f} GFLOP) = {ms / b_ms:.1f}x bound; passes "
          f"(torch.profiler, device us per call): "
          + (", ".join(f"{k} {v * 1e3:.2f}" for k, v in passes.items())
             or "not measured (no device time reported)"))
    rows["ssd_scan"]["serve_h0"] = {
        **out, "shape": f"x [{B},{S},{H},{P}] bf16, h0 [{B},{H},{P},{N}] "
        f"fp32, Q={Q}", "ms": ms, "ms_without_h0": ms0,
        "eager_ms": eager_ms, "pass_ms": passes,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}


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
        rb_ms, rby, _, _ = kernel_bound("rmsnorm_rows", R=S, d=d,
                                        itemsize=2)
        print(f"[kernels] rmsnorm_rows bf16 x [{S},{d}] (mamba2 training): "
              f"max|d|={e:.3e} (tol 1e-06+0.0078125*|ref|) ok; "
              f"{rmsnorm_line(t)}; bound {rb_ms * 1e3:.3f} us ({rby}, "
              f"kernel_cost)")
        out[f"x [{S},{d}] bf16"] = {
            "max_abs_err": e, **t, "bound_ms": rb_ms, "bound_by": rby}
    rows["rmsnorm_rows"]["train_mamba2"] = out


SPLIT_D = 2560           # a tp rank's columns of mamba2-2.7b's gated norm
SPLIT_ROWS = TRAIN_SEQ   # rows timed (the main path gives TRAIN_SEQ - 1)


def phase_rmsnorm_split(torch, gen, rows):
    """The split-width RMSNorm pair (``rmsnorm_sumsq_rows``, then
    ``rmsnorm_scale_rows`` from the whole rows' sums) against its plain
    versions: at a tp 2 rank's part of mamba2-2.7b's gated norm
    ([2048, 2560], the main path's rows, and [2049, 2560]), at [7, 100]
    (the scalar loop in bf16) and [300, 5120], in bf16 and fp32, the
    sums to 1e-5 relative and the rows at phase 3's rmsnorm tolerances;
    the pair joined over two column halves of a row against
    ``rmsnorm_rows`` over the whole row.  Timed at [2049, 2560] bf16 and
    fp32 from device memory (rotating inputs), each kernel beside its
    plain version and its bound, the pair beside ``rmsnorm_rows`` at the
    whole [2049, 5120] (the same bytes of x).  Then the SSD scan at a tp
    2 rank's heads of mamba2-2.7b (x [1, 2048, 40, 64]) in bf16 against
    its plain version, timed.  Returns the two kernels' rows of the
    kernels line."""
    from repro_torch.kernels.rmsnorm import (rmsnorm_rows,
                                             rmsnorm_scale_rows,
                                             rmsnorm_scale_rows_ref,
                                             rmsnorm_sumsq_rows,
                                             rmsnorm_sumsq_rows_ref)
    eps = 1e-6
    tols = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-6, 2.0 ** -7)}
    worst = {"rmsnorm_sumsq_rows": 0.0, "rmsnorm_scale_rows": 0.0}
    for dt, (atol, rtol) in tols.items():
        for R, d in ((SPLIT_ROWS - 1, SPLIT_D), (SPLIT_ROWS, SPLIT_D),
                     (7, 100), (300, 5120)):
            x = torch.randn((R, d), generator=gen, device="cuda").to(dt)
            scale = (1 + 0.1 * torch.randn((d,), generator=gen,
                                           device="cuda")).to(dt)
            ss = rmsnorm_sumsq_rows(x)
            want_ss = rmsnorm_sumsq_rows_ref(x)
            # the whole rows' sums: this part's and a second part's
            full = ss + 0.5 * want_ss
            y = rmsnorm_scale_rows(x, full, scale, 2 * d, eps)
            torch.cuda.synchronize()
            want = rmsnorm_scale_rows_ref(x, full, scale, 2 * d, eps)
            e_ss, e_y = max_err(ss, want_ss), max_err(y, want)
            ok = rel_ok(ss, want_ss, 0.0, 1e-5) and rel_ok(y, want, atol,
                                                           rtol)
            print(f"[kernels] rmsnorm split pair {str(dt)[6:]} R={R} d={d}:"
                  f" sums max|d|={e_ss:.3e} (tol 1e-05*|ref|), rows "
                  f"max|d|={e_y:.3e} (tol {atol:g}+{rtol:g}*|ref|) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the split-width RMSNorm pair disagrees with its plain "
                     f"versions ({dt}, R={R}, d={d})")
            worst["rmsnorm_sumsq_rows"] = max(worst["rmsnorm_sumsq_rows"],
                                              e_ss)
            worst["rmsnorm_scale_rows"] = max(worst["rmsnorm_scale_rows"],
                                              e_y)
        # two column halves of each row against the one-launch kernel
        R, d = SPLIT_ROWS - 1, 2 * SPLIT_D
        x = torch.randn((R, d), generator=gen, device="cuda").to(dt)
        scale = (1 + 0.1 * torch.randn((d,), generator=gen,
                                       device="cuda")).to(dt)
        halves = [x[:, :SPLIT_D].contiguous(), x[:, SPLIT_D:].contiguous()]
        tot = rmsnorm_sumsq_rows(halves[0]) + rmsnorm_sumsq_rows(halves[1])
        y = torch.cat([rmsnorm_scale_rows(h, tot, scale[i * SPLIT_D:(i + 1)
                                                         * SPLIT_D]
                                          .contiguous(), d, eps)
                       for i, h in enumerate(halves)], dim=1)
        whole = rmsnorm_rows(x, scale, eps)
        torch.cuda.synchronize()
        e = max_err(y, whole)
        ok = rel_ok(y, whole, atol, rtol)
        print(f"[kernels] rmsnorm split pair {str(dt)[6:]} over two halves "
              f"of [{R}, {d}] against rmsnorm_rows on the whole rows: "
              f"max|d|={e:.3e} (tol {atol:g}+{rtol:g}*|ref|) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the split pair over two halves differs from rmsnorm_rows "
                 f"({dt})")
    out = {}
    for name in worst:
        out[name] = {"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/rmsnorm.cu",
                     "replaces": "src/repro/kernels/rmsnorm/kernel.py:18",
                     "max_abs_err": worst[name], "library_ms": None,
                     "timed_shape": f"x [{SPLIT_ROWS},{SPLIT_D}] bf16"}
    for dt in (torch.bfloat16, torch.float32):
        R, d = SPLIT_ROWS, SPLIT_D
        x = torch.randn((R, d), generator=gen, device="cuda").to(dt)
        scale = (1 + 0.1 * torch.randn((d,), generator=gen,
                                       device="cuda")).to(dt)
        ss = rmsnorm_sumsq_rows_ref(x) * 2
        sets = rotating(torch, (x, scale, ss))
        t = {"rmsnorm_sumsq_rows": (
            cold_ms(lambda a, b, c: rmsnorm_sumsq_rows(a), sets),
            cold_ms(lambda a, b, c: rmsnorm_sumsq_rows_ref(a), sets)),
             "rmsnorm_scale_rows": (
            cold_ms(lambda a, b, c: rmsnorm_scale_rows(a, c, b, 2 * d, eps),
                    sets),
            cold_ms(lambda a, b, c: rmsnorm_scale_rows_ref(a, c, b, 2 * d,
                                                           eps), sets))}
        del sets
        xw = torch.randn((R, 2 * d), generator=gen, device="cuda").to(dt)
        sw = torch.ones((2 * d,), dtype=dt, device="cuda")
        wsets = rotating(torch, (xw, sw))
        whole_ms = cold_ms(lambda a, b: rmsnorm_rows(a, b, eps), wsets)
        del wsets
        pair = sum(k for k, _ in t.values())
        wb_ms, _, _, _ = kernel_bound("rmsnorm_rows", R=R, d=2 * d,
                                      itemsize=x.element_size())
        parts = []
        for name, (k_ms, p_ms) in t.items():
            b_ms, by, _, _ = kernel_bound(name, R=R, d=d,
                                          itemsize=x.element_size())
            parts.append(f"{name} {k_ms * 1e3:.2f} us (plain "
                         f"{p_ms * 1e3:.2f}, bound {b_ms * 1e3:.3f} us, "
                         f"{by})")
            if dt == torch.bfloat16:
                out[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                 bound_by=by)
            else:
                out[name]["fp32"] = {"ms": k_ms, "plain_ms": p_ms,
                                     "bound_ms": b_ms}
        print(f"[kernels] rmsnorm split pair {str(dt)[6:]} x [{R},{d}] (a "
              f"tp 2 rank of mamba2-2.7b's gated norm; device time per "
              f"call, from device memory, CUDA graph): {'; '.join(parts)};"
              f" the pair {pair * 1e3:.2f} us against rmsnorm_rows on the "
              f"whole [{R},{2 * d}] {whole_ms * 1e3:.2f} us (bound "
              f"{wb_ms * 1e3:.3f} us); no library call takes a partial "
              f"sum of squares")
        for name in t:
            out[name].setdefault("whole_row_ms", {})[str(dt)[6:]] = whole_ms
    phase_ssd_tp(torch, gen, rows)
    return [out["rmsnorm_sumsq_rows"], out["rmsnorm_scale_rows"]]


def phase_ssd_tp(torch, gen, rows):
    """The SSD scan at a tp 2 rank's heads of mamba2-2.7b in training (x
    [1, 2048, 40, 64], B and C [1, 2048, 128], Q=128, bf16) against
    ``ssd_chunked_ref``, timed beside it and its bound."""
    from repro_torch.kernels.ssd_scan import ssd_chunked_ref, ssd_scan
    B, S, H, P, N, Q = 1, TRAIN_SEQ - 1, 40, 64, 128, 128
    ins = _ssd_inputs(torch, gen, B, S, H, P, N, torch.bfloat16)
    y, h = ssd_scan(*ins, chunk=Q)
    torch.cuda.synchronize()
    yr, hr = ssd_chunked_ref(*ins, Q)
    e = max(max_err(y, yr), max_err(h, hr))
    scale = max(1.0, float(yr.abs().max()), float(hr.abs().max()))
    if e > SSD_TOL * scale:
        fail(f"ssd_scan at the tp rank's shape: max|d| {e:.3e} > "
             f"{SSD_TOL} x {scale:.3g}")
    ms = time_ms(lambda: ssd_scan(*ins, chunk=Q), iters=50, warmup=5)
    plain_ms = time_ms(lambda: ssd_chunked_ref(*ins, Q), iters=5, warmup=1)
    b_ms, by, _, _ = kernel_bound("ssd_scan", B=B, S=S, H=H, P=P, N=N, Q=Q,
                                  itemsize=2)
    print(f"[kernels] ssd_scan bf16 at a tp 2 rank of mamba2-2.7b, x "
          f"[{B},{S},{H},{P}], N={N}, Q={Q}: max|d|={e:.3e} (tol {SSD_TOL} "
          f"x {scale:.3g}) ok; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(CUDA events), bound {b_ms * 1e3:.2f} us ({by}, kernel_cost)")
    rows["ssd_scan"]["train_tp2"] = {"max_abs_err": e, "ms": ms,
                                     "plain_ms": plain_ms, "bound_ms": b_ms,
                                     "bound_by": by}


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


def expected_train_launches(spec, n_leaves: int, tp: int = 1):
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
    split backward: zero-bubble and V-shape), else not at all.  Under
    ``tp`` > 1 the Mamba-2 gated norm's row spans the ranks: it launches
    the split-width pair (``rmsnorm_sumsq_rows`` and
    ``rmsnorm_scale_rows``, once each) in place of ``rmsnorm_rows``."""
    cfg = spec.cfg
    attn, mamba = _layers_of(spec, "attn"), _layers_of(spec, "mamba")
    split = mamba if tp > 1 else 0
    rms = attn + 2 * mamba - split + (attn + mamba) * (cfg.d_ff > 0) \
        + (attn + mamba) * (cfg.encdec is not None)
    n_enc = cfg.encdec.num_encoder_layers if cfg.encdec is not None else 0
    n = {"flash_attention_fwd": 0, "rmsnorm_rows": 0, "ssd_scan": 0}
    for _, first, last in _body_ops(spec):
        n["flash_attention_fwd"] += attn + first * n_enc
        n["ssd_scan"] += mamba
        n["rmsnorm_rows"] += rms + last + first * (2 * n_enc + (n_enc > 0))
    if tp > 1:
        ops = sum(1 for _ in _body_ops(spec))
        n["rmsnorm_sumsq_rows"] = n["rmsnorm_scale_rows"] = split * ops
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
                inspect=None, seq=TRAIN_SEQ, count=False, steps=4, **plan):
    """Full-width ``arch`` (cut to ``layers`` layers if given) trained
    ``steps`` steps on ``P`` virtual stages through ``train_pipeline``, with phase
    6's plan (chronos_zb) or ``plan``'s overrides of it (phases 12-14:
    v_min, chronos_seq, seq1f1b); launch counts from the table; then one
    more step under the profiler.  ``bwd_ms``: layer kind -> the per-call
    time of its kernel Function's plain backward at the training shape
    (phase 3), or None where phase 3 did not time this model's shape.
    ``inspect(tc, spec, out)`` runs on the trained state before it is
    freed.  With ``count``, one more step is counted for phase 26
    (:func:`count_train_step`).  Returns the launch counts, losses, peak
    memory and median step (phase 11 holds its offload runs against
    them)."""
    from repro_torch.core.pipeline_runtime import init_pipeline_params
    from repro_torch.launch.train import train_pipeline
    from repro_torch.tree import tree_leaves
    tc = _train_config(arch, layers=layers, seq=seq, **plan)
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
    med = warm_median(out["step_s"])                # step 1 warms up
    print(f"[{tag}] steps={out['steps']} losses={out['losses']} "
          f"grad_norms={out['grad_norms']} lrs={out['lrs']} "
          f"step_s={out['step_s']}")
    print(f"[{tag}] {median_word(out['step_s'])} {med * 1e3:.1f} ms "
          f"(steps 2-{steps}: "
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
        for _ in range(2):
            if ssd_counts == want_ssd:
                break
            # a profiler session on the card now and then drops records,
            # in bursts (see _ssd_kernel_ms): the count must be seen whole
            # once, in a session a second apart from the last
            print(f"[{tag}] the profiler recorded SSD kernels {ssd_counts} "
                  f"of {want_ssd}: one more step traced")
            time.sleep(1.0)
            ssd_counts = profile_train_step(torch, tc, P, out["params"],
                                            out["opt_state"], med, tag, bwd)
        print(f"[{tag}] ssd_scan kernels in the profiled step: {ssd_counts}")
        if ssd_counts != want_ssd:
            fail(f"{arch}: the profiled step ran SSD kernels {ssd_counts}, "
                 f"not the tensor-core route's {want_ssd}")
    if count:
        count_train_step(torch, tag, tc, P, out["params"], out["opt_state"],
                         med)
    summary = {"losses": out["losses"], "grad_norms": out["grad_norms"],
               "peak": peak, "median_s": med,
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
    for key, count, dev in _device_rows(prof):
        m = re.search(r"\bssd_scan_kernel\w*", key)
        if m:
            ssd_counts[m.group(0)] = ssd_counts.get(m.group(0), 0) + count
        if dev <= 0:
            continue
        rows.append((dev, count, key))
        name = key.lower()
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

def _single_config(arch: str, rc, mbB: int, layers=None):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import (OptimizerConfig, ParallelPlan,
                                          ShapeConfig, TrainConfig)
    cfg = get_config(arch)
    return TrainConfig(
        model=cfg if layers is None else dataclasses.replace(
            cfg, num_layers=layers),
        shape=ShapeConfig("train_2k", seq_len=TRAIN_SEQ, global_batch=8,
                          kind="train"),
        plan=ParallelPlan(num_chunks=2, microbatch_size=mbB, recompute=rc,
                          kernels="fused"),
        optimizer=OptimizerConfig(warmup_steps=2, total_steps=4),
        seed=0, log_every=1)


def expected_single_launches(cfg, m: int, tp: int = 1):
    """Kernel launches of one ``train()`` step of ``m`` microbatches: every
    layer launches flash (attention) or the SSD scan (Mamba-2) once and
    rmsnorm for ``norm1``, the Mamba-2 gated norm and ``norm2`` where the
    config has an FFN; a layer of the periods under a checkpoint launches
    them again when its backward recomputes it (every recompute mode
    wraps every period, ``none`` selectively); remainder layers run
    once.  The final norm is the plain one of ``LM.head``, and the update
    is the plain AdamW: no fused-AdamW launch.  Under ``tp`` > 1 the
    Mamba-2 gated norm launches the split-width pair in place of
    ``rmsnorm_rows``.  An encoder-decoder's layers add ``norm_x`` (its
    cross-attention takes the plain path), and its encoder runs once a
    microbatch outside the checkpoints: per encoder layer one flash
    kernel (``causal=False``) and rmsnorm twice, then ``enc_norm``."""
    wrapped = cfg.num_layers // cfg.period * cfg.period
    n_enc = cfg.encdec.num_encoder_layers if cfg.encdec is not None else 0
    n = {"flash_attention_fwd": 0, "rmsnorm_rows": 0, "ssd_scan": 0,
         "fused_adamw_flat": 0}
    if tp > 1:
        n["rmsnorm_sumsq_rows"] = n["rmsnorm_scale_rows"] = 0
    for idx in range(cfg.num_layers):
        times = m * (2 if idx < wrapped else 1)
        kind = cfg.layer_kind(idx)
        gated = kind == "mamba"
        n["flash_attention_fwd"] += times * (kind == "attn")
        n["ssd_scan"] += times * gated
        n["rmsnorm_rows"] += times * (1 + (gated and tp == 1)
                                      + (cfg.d_ff > 0) + (n_enc > 0))
        if tp > 1:
            n["rmsnorm_sumsq_rows"] += times * gated
            n["rmsnorm_scale_rows"] += times * gated
    n["flash_attention_fwd"] += m * n_enc
    n["rmsnorm_rows"] += m * (2 * n_enc + (n_enc > 0))
    return n


def train_single_run(torch, arch: str, rc, mbB: int, tag: str,
                     steps: int = 4, profile: bool = False, layers=None,
                     count: bool = False):
    """Full-width ``arch`` through ``repro_torch.launch.train.train`` with
    recompute ``rc``, ``steps`` steps from random weights (seed 0), the
    peak counted from a reset after the earlier tensors are freed; checks
    launches, finite losses and gradient norms and moved masters.  With
    ``profile``, one more step under the profiler; with ``count``, one
    more counted for phase 26.  Returns (summary, launches).  ``layers``
    cuts the depth."""
    from repro_torch.launch.train import train
    from repro_torch.models import LM
    from repro_torch.tree import tree_leaves
    tc = _single_config(arch, rc, mbB, layers)
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
    med = warm_median(out["step_s"])                # step 1 warms up
    print(f"[{tag}] losses={out['losses']} grad_norms={out['grad_norms']} "
          f"step_s={out['step_s']}")
    print(f"[{tag}] {median_word(out['step_s'])} {med * 1e3:.1f} ms "
          f"(steps 2-{steps}: "
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
    if count:
        count_train_step(torch, tag, tc, None, out["params"],
                         out["opt_state"], med)
    summary = {"losses": out["losses"], "grad_norms": out["grad_norms"],
               "median_ms": med * 1e3, "tokens_per_s": tokens / med,
               "peak_gib": peak / 2 ** 30}
    del out, params, leaves, masters
    gc.collect()
    torch.cuda.empty_cache()
    return summary, launches


def single_modes():
    """Phase 10's recompute modes of tinyllama-1.1b, by name."""
    from repro_torch.configs.base import RecomputeConfig
    return {"none": RecomputeConfig("none"),
            "chronos": RecomputeConfig("chronos", num_recomp_chunks=1,
                                       policy="full"),
            "full": RecomputeConfig("full")}


def phase_train_single(torch):
    """10. ``train()`` at full width: tinyllama-1.1b in the recompute
    modes none, chronos (the shallow chunk fully rematerialized) and full,
    microbatch 4 (m = 2), a profiled chronos step; mamba2-2.7b cut to
    ``MAMBA2_TRAIN_LAYERS`` layers in chronos, microbatch 1 (m = 8).  Step-1 losses bitwise across the modes, their
    gradient norms to 1e-6, peaks ordered none > chronos > full.  Returns
    the launch counts per path."""
    modes = single_modes()
    runs, total = {}, {}
    for name, rc in modes.items():
        runs[name], n = train_single_run(
            torch, "tinyllama-1.1b", rc, 4, f"train-single-{name}",
            steps=SINGLE_STEPS, profile=name == "chronos", count=True)
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
        torch, "mamba2-2.7b", modes["chronos"], 1, "train-single-mamba2",
        steps=SINGLE_STEPS, layers=MAMBA2_TRAIN_LAYERS)
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
    print(f"[{tag}] {median_word(out['step_s'])} {med * 1e3:.1f} ms "
          f"(steps 2-{steps}: "
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
    base["offload_run"] = {"peak": peak, "launches": launches,
                           "per_step": {k: n // steps
                                        for k, n in want.items()},
                           "median_s": med, "losses": out["losses"],
                           "bytes_down": rep["bytes_down"],
                           "copy_down_gbps": rep["copy_down_gbps"],
                           "collect_wait_s": rep["collect_wait_s"]}
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
                             base["tinyllama-1.1b"], OFFLOAD_STEPS)
    done("train-offload tinyllama-1.1b")
    mamba = train_offload_run(torch, "mamba2-2.7b", "train-offload-mamba2",
                              base["mamba2-2.7b"], OFFLOAD_STEPS)
    done("train-offload mamba2-2.7b")
    return {"train_offload_tinyllama": tiny, "train_offload_mamba2": mamba}


# steps of phase 11's fp32 checks (3 before phase 30 needed the time)
OFFLOAD_CHECK_STEPS = 2


def _fp32_offload_losses(torch, cfg, ocfg, mode: str):
    """``OFFLOAD_CHECK_STEPS`` steps of ``cfg`` (fp32), chronos_zb P=2,
    v=2, m=4, mbB=1, seq 257,
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
        return train_pipeline(tc, P=2, device="cuda",
                              steps=OFFLOAD_CHECK_STEPS,
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
    for _ in range(OFFLOAD_CHECK_STEPS):
        toks = torch.from_numpy(src.next_batch(m * mbB).reshape(m, mbB, -1))
        params, opt, met = step(params, opt, {"tokens": toks.to(dev)})[:3]
        losses.append(float(met["loss"]))
        for w in tree_leaves(deep):
            w.copy_(w.to(torch.bfloat16))
    return losses


def phase_train_offload_checks(torch):
    """fp32, full width, 4 layers, the optimizer of phases 6 and 8 with
    the gradient clip off, ``OFFLOAD_CHECK_STEPS`` steps, same weights and
    data
    (:func:`_fp32_offload_losses`): (a) offload against the port's
    on-device optimizer, step-1 losses bitwise, then within the
    reference's 5e-3; (b) offload against the on-device optimizer with
    the deep weights rounded to bf16 after every step, within 1e-4: what
    is left is the host update's own rounding.  The clip stays off: the
    host update never clips the deep gradients and the device clip covers
    only the shallow and shared leaves, as in the reference
    (``tests/test_torch_mesh_offload.py`` holds that clip), so a clip
    coefficient that moves from step to step would move Adam's
    normalised steps apart."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig
    ocfg = OptimizerConfig(warmup_steps=2, total_steps=4, grad_clip=0.0)
    for arch in ("tinyllama-1.1b", "mamba2-2.7b"):
        cfg = dataclasses.replace(get_config(arch), num_layers=4,
                                  param_dtype="float32",
                                  compute_dtype="float32")
        runs = {}
        for mode in ("device", "offload", "device+bf16"):
            runs[mode] = _fp32_offload_losses(torch, cfg, ocfg, mode)
            gc.collect()
            torch.cuda.empty_cache()
        off = runs["offload"]
        d_a = max(abs(a - b) for a, b in zip(runs["device"], off))
        d_b = max(abs(a - b) for a, b in zip(runs["device+bf16"], off))
        first = runs["device"][0] == off[0]
        print(f"[train-offload-check] {arch} fp32 4 layers, grad_clip 0.0, "
              f"{OFFLOAD_CHECK_STEPS} steps: on-device {runs['device']}, "
              f"offload {off}, on-device with bf16 deep weights "
              f"{runs['device+bf16']}; offload - on-device max |d| "
              f"{d_a:.3e}, offload - bf16-deep on-device max |d| "
              f"{d_b:.3e}; step 1 {'bitwise' if first else 'DIFFERS'} "
              f"(tols 5e-3 and 1e-4)")
        if not (first and d_a <= 5e-3 and d_b <= 1e-4):
            fail(f"{arch}: offload training departs from the on-device "
                 "optimizer")


# ---------------------------------------------------------------------------
# V-shape and sequence-chunked pipeline schedules
# ---------------------------------------------------------------------------

def phase_train_schedules(torch, bwd_ms, base):
    """Phases 12-14: full-width tinyllama-1.1b cut to
    ``SEQ_TRAIN_LAYERS`` layers through ``train_pipeline`` as phase 6
    (seed, data, optimizer, fused kernels, P=4, m=8, one 2049-token
    sequence per microbatch, ``SCHEDULE_STEPS`` steps, launch counts from
    the table, a profiled step) with v_min (v=2, the fold-back placement, split
    backward and fused AdamW), chronos_seq (v=2, n_seq=2,
    ``RecomputeConfig("chronos", num_recomp_chunks=1)``) and seq1f1b
    (v=1, n_seq=4), each printed beside phase 6.  Returns the launch
    counts by path."""
    from repro_torch.configs.base import RecomputeConfig
    launches = {}
    ref = base["tinyllama-1.1b"]
    for tag, plan in (
            ("train-vshape", dict(schedule="v_min",
                                  layers=SEQ_TRAIN_LAYERS)),
            ("train-seq-chronos", dict(
                schedule="chronos_seq", seq_chunks=2,
                recompute=RecomputeConfig("chronos", num_recomp_chunks=1),
                layers=SEQ_TRAIN_LAYERS)),
            ("train-seq-1f1b", dict(schedule="seq1f1b", num_chunks=1,
                                    seq_chunks=4, layers=SEQ1F1B_LAYERS))):
        out = phase_train(torch, "tinyllama-1.1b", tag, bwd_ms,
                          steps=SCHEDULE_STEPS, **plan)
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
    med = warm_median(out["step_s"])                # step 1 warms up
    print(f"[{tag}] losses={out['losses']} grad_norms={out['grad_norms']} "
          f"step_s={out['step_s']}")
    print(f"[{tag}] {median_word(out['step_s'])} {med * 1e3:.1f} ms "
          f"(steps 2-{steps}: "
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
    tinyllama-1.1b under a quarter of the card per stage, trained
    ``PLANNER_STEPS`` steps as phase 6 (8 sequences of 2049 tokens);
    (b) for deepseek-7b's
    published width, ``max_trainable_layers`` of ``1f1b`` and of the
    best point under the same budget, then the pick for the best depth
    trained 2 steps with ``ep.m`` sequences at ``DEEPSEEK_TRAIN_LAYERS``
    layers; (c) for every pipeline
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
        "train-planner", cfg, ep, 8, PLANNER_STEPS)[0]
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
    ep = plan_under_budget(dataclasses.replace(wide, num_layers=depth),
                           pp=4, tp=1, hbm_bytes=hbm, microbatch=1,
                           seq_len=TRAIN_SEQ)
    # the pick for the largest depth, trained at a cut depth (the smoke's
    # time limit); (c) holds its peak against the prediction for the
    # depth trained
    layers = min(depth, DEEPSEEK_TRAIN_LAYERS)
    deep_cfg = dataclasses.replace(wide, num_layers=layers)
    unit = 4 * ep.point.v
    if layers % unit:
        print(f"[train-planner-deepseek] {layers} layers pad to "
              f"{-(-layers // unit) * unit}: the padding layers hold "
              f"weights and optimizer state the model does not count")
    n, peak_b, med_b = trained("train-planner-deepseek", deep_cfg, ep, ep.m,
                               DEEPSEEK_STEPS)
    launches["train_planner_deepseek"] = n
    tokens = ep.m * (TRAIN_SEQ - 1)
    print(f"[train-planner-deepseek] the {depth}-layer pick trained at "
          f"{layers} layers ({deep_cfg.param_count() / 1e9:.3f} B "
          f"parameters) on one card: step {med_b * 1e3:.1f} ms, "
          f"{tokens / med_b:.1f} tokens/s, peak {peak_b / 2 ** 30:.3f} GiB; "
          f"1f1b fits {ladder['1f1b']} layers")
    done("train-planner deepseek-7b")

    # (c) every pipeline training plan: predicted against measured
    from repro_torch.launch.dryrun import predicted_card_peak
    for tag, tc, P, peak in TRAIN_RUNS:
        total, state, act, kv = predicted_card_peak(tc.model, tc.shape,
                                                    tc.plan, P)
        pt = _point_of(tc, planner_query(tc.model, hbm * 4 / P, pp=P))
        per_stage = f"{pt.total_bytes / 2 ** 30:.3f} GiB ({pt.describe()})" \
            if pt is not None else "not a point of the design space"
        print(f"[train-planner-model] phase {PHASE_OF[tag]} {tag} "
              f"{tc.model.name} {tc.plan.schedule}: planner per-stage total "
              f"{per_stage}; card prediction {total / 2 ** 30:.3f} GiB = "
              f"{P} x model_state {state / 2 ** 30:.3f} + activations "
              f"{act / 2 ** 30:.3f} + kv-carry {kv / 2 ** 30:.3f} + reserve "
              f"{(total - state - act - kv) / 2 ** 30:.3f}; measured peak "
              f"{peak / 2 ** 30:.3f} GiB; measured / predicted "
              f"{peak / total:.3f}")
    return launches


# ---------------------------------------------------------------------------
# windowed layers, the VLM patch prefix and the encoder-decoder (gemma3-27b,
# paligemma-3b, whisper-base)
# ---------------------------------------------------------------------------

GEMMA3_ARGV = ["--chunk", "128", "--prompt-chunks", "12",
               "--prompt-len", "1536"]     # max_seq = 1536 + 16 + 512


def phase_serve_gemma3(torch):
    """17. gemma3-27b served at full width through ``launch.serve.main``
    (P=1, 4 slots, 128-token chunks, prompts of 1-12 chunks, 8-16 new
    tokens, 8 requests at t=0), gated as phase 4; the requests whose
    prompts pass the 1024-token window (at least two), the peak beside
    its reckoning.  Returns the launch counts."""
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
                            prompt_range=(1, 12), gen_range=FAMILY_GEN,
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
            retired, tok, lg, finite = tick(inj)
            if lg is not None:
                got.setdefault(retired.rid, []).append(lg.float().cpu())
            return retired, tok, lg, finite
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
    from repro_torch.launch.dryrun import predicted_card_peak
    tc = _train_config(arch, seq=seq)
    total, state, act, kv = predicted_card_peak(tc.model, tc.shape, tc.plan,
                                                P)
    print(f"[{tag}] peak {out['peak'] / 2 ** 30:.3f} GiB against the card "
          f"prediction {total / 2 ** 30:.3f} GiB ({P} x model_state "
          f"{state / 2 ** 30:.3f} + activations {act / 2 ** 30:.3f} + "
          f"reserve {(total - state - act - kv) / 2 ** 30:.3f}); measured / "
          f"predicted "
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


# ---------------------------------------------------------------------------
# resilient serving (A.5) and single-host batched serving
# ---------------------------------------------------------------------------

RESILIENT_P = 3          # 22 layers pad to 24 at P=3; none at P=2 and P=1
STRAGGLER_TICKS, STRAGGLER_FACTOR = 6, 50.0
# the CLI's overload run: 16 bursty requests at 2 req/s calm and 10 in
# bursts, at phase 4's ~30 ms a tick; a fake pipeline at that tick time
# completes 7, expires 5 and sheds 4 of them
BURSTY_ARGV = ["--pipelined", "2", "--requests", "16", "--rate", "2",
               "--bursty", "--deadline-s", "4", "--max-queue", "4"]
BATCHED_ARGV = ["--arch", "tinyllama-1.1b", "--full", "--pipelined", "0",
                "--batch", "4", "--prompt-len", "512", "--gen", "32",
                "--device", "cuda", "--kernels", "fused"]


class TickLog:
    """While active, records every engine's injections, one list per engine
    in the order the engines first tick (without holding the engines)."""

    def __enter__(self):
        from repro_torch.serve import PipelinedEngine
        self.engines, self.cls = [], PipelinedEngine
        self.orig = orig = PipelinedEngine.tick
        engines = self.engines

        def logged(eng, inj):
            if getattr(eng, "_tick_log", None) is None:
                eng._tick_log = {"P": eng.P,
                                 "K": eng.layout.L_pad // eng.P, "ops": []}
                engines.append(eng._tick_log)
            eng._tick_log["ops"].append(inj.op)
            return orig(eng, inj)
        PipelinedEngine.tick = logged
        return self

    def __exit__(self, *exc):
        self.cls.tick = self.orig

    def stage_runs(self):
        """Per engine, its prefill and decode stage runs: injection i of an
        engine that ticked N times ran stages 0 .. min(P, N - i) - 1."""
        from repro_torch.serve import DECODE, PREFILL
        out = []
        for e in self.engines:
            N, runs = len(e["ops"]), {"prefill": 0, "decode": 0}
            for i, op in enumerate(e["ops"]):
                if op in (PREFILL, DECODE):
                    runs["prefill" if op == PREFILL else "decode"] += \
                        min(e["P"], N - i)
            out.append((e["P"], e["K"], runs))
        return out

    def launches(self, cfg):
        """Kernel launches derived from the stage runs: each runs its
        stage's K layers (padding layers too, at gate 0)."""
        import dataclasses
        want = {}
        for _, K, runs in self.stage_runs():
            per = serve_launches(dataclasses.replace(cfg, num_layers=K),
                                 runs["prefill"], runs["decode"])
            want = {k: want.get(k, 0) + n for k, n in per.items()}
        return want


def _streams(res):
    return {rid: rec.tokens for rid, rec in res["finished"].items()}


def _serve_line(tag, what, res):
    from repro_torch.serve import summarize
    s = summarize(res)
    print(f"[{tag}] {what}: ticks={res['ticks']} tokens={s['output_tokens']} "
          f"wall {s['elapsed_s']:.3f} s, tokens/s={s['tokens_per_s']:.2f} "
          f"ttft p50={s['ttft_p50_s'] * 1e3:.2f}ms p99="
          f"{s['ttft_p99_s'] * 1e3:.2f}ms per-token p50="
          f"{s['tok_p50_s'] * 1e3:.3f}ms p99={s['tok_p99_s'] * 1e3:.3f}ms")
    return s


def phase_serve_resilient(torch):
    """23. Resilient serving at full width: tinyllama-1.1b, all 22 layers,
    bf16, fused kernels, 4 slots, 64-token chunks, max_seq 512, phase 4's
    8 requests (``SERVE_ARGV``) at once (``clock=None``).  (a) the engine
    at P=1 without faults: the stream oracle; (b) ``serve_resilient`` at
    P=3 without faults (its retire ticks stage the faults), and the P=3
    engine without a monitor (what the monitor's per-tick synchronize
    costs); (c) ``serve_resilient`` at P=3 through a slot corruption
    (slot 0, early), a straggler window, stage slot 1 lost after the first
    completion and a hung tick later, which the watchdog on the injector's
    clock turns into a second loss: P 3 -> 2 -> 1, on the same seed's
    weights made anew and consumed by the first engine, as the CLI's
    ``--fault`` path runs (the peak is that path's).  Gates: every request
    completed with (a)'s stream, the two recoveries with their
    re-admissions, the retries, three injector events and all four faults
    fired, a checkpoint_now then a restart in the straggler window, no
    non-finite logits on an accepted wave (on none at all in the
    fault-free runs), launches derived from each engine's injections.  Then the CLI's overload path (``BURSTY_ARGV``
    through ``main``: P=2, bursty arrivals, deadlines, a queue bound):
    every request in one terminal state, no slot left occupied, the
    completed streams equal to a P=1 ``clock=None`` run's, launches
    derived.  Returns the launches of (c) and of the CLI run."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.ft import (FaultInjector, HungTick, SlotCorruption,
                                StragglerTicks, TickDeviceLoss)
    from repro_torch.launch.serve import build_parser
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import LM
    from repro_torch.serve import (PipelinedEngine, poisson_requests,
                                   serve_resilient)
    tag = "serve-resilient"
    args = build_parser().parse_args(SERVE_ARGV)
    cfg = get_config(args.arch)
    chunk, n_slots, P = args.chunk, args.slots, RESILIENT_P
    max_seq = args.prompt_len + args.gen + 4 * chunk
    reqs = poisson_requests(args.requests, args.rate, chunk=chunk,
                            max_seq=max_seq,
                            prompt_range=(1, args.prompt_chunks),
                            gen_range=(args.gen_min, args.gen),
                            vocab=cfg.vocab_size, seed=0)
    kw = dict(chunk=chunk, max_seq=max_seq, n_slots=n_slots, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    lm = LM(cfg, device="cuda")
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    print(f"[{tag}] {cfg.name} full width bf16, {cfg.num_layers} layers, "
          f"{len(reqs)} requests at once, {n_slots} slots, chunk {chunk}, "
          f"max_seq {max_seq}")

    # (a) the oracle: P=1, no faults
    eng = PipelinedEngine(cfg, params, P=1, **kw)
    res_a = eng.serve(reqs, clock=None)
    del eng
    oracle = _streams(res_a)
    _serve_line(tag, "(a) engine P=1, no faults, no monitor", res_a)
    if len(oracle) != len(reqs):
        fail(f"{tag}: (a) completed {sorted(oracle)}")

    # (b) P=3 without faults: through serve_resilient (monitor on), then
    #     the bare engine (no monitor)
    res_b = serve_resilient(cfg, params, reqs, P=P, clock=None,
                            log=lambda m: None, **kw)
    s_b = _serve_line(tag, f"(b) serve_resilient P={P}, no faults", res_b)
    eng = PipelinedEngine(cfg, params, P=P, **kw)
    res_b2 = eng.serve(reqs, clock=None)
    del eng
    s_b2 = _serve_line(tag, f"(b') engine P={P}, no monitor", res_b2)
    print(f"[{tag}] the monitor's per-tick synchronize: tokens/s "
          f"{s_b['tokens_per_s']:.2f} with, {s_b2['tokens_per_s']:.2f} "
          f"without ({100 * (s_b['tokens_per_s'] / s_b2['tokens_per_s'] - 1):+.1f}%)"
          f"; health actions of (b): {res_b['health_actions']}")
    if _streams(res_b) != oracle or _streams(res_b2) != oracle:
        fail(f"{tag}: fault-free P={P} streams differ from P=1's")
    # no fault: a non-finite logit on any wave, stale or not, is a fault
    for name, r in (("a", res_a), ("b", res_b), ("b'", res_b2)):
        if r["nonfinite_logits"] or r["stale_nonfinite_logits"]:
            fail(f"{tag}: fault-free run ({name}) had non-finite logits: "
                 f"accepted {r['nonfinite_logits']}, stale "
                 f"{r['stale_nonfinite_logits']}")
    if res_b["recoveries"]:
        fail(f"{tag}: the fault-free run recovered: {res_b['recoveries']}")
    done = sorted(r.done_tick for r in res_b["finished"].values())
    corrupt_tick = P + 3
    slow_tick = corrupt_tick + 6
    loss_tick = done[0] + max(1, (done[-1] - done[0]) // 4)
    hung_tick = loss_tick + max(P + 2, (done[-1] - loss_tick) // 2)
    if not corrupt_tick < slow_tick + STRAGGLER_TICKS < done[0] <= loss_tick:
        fail(f"{tag}: retire ticks {done} too early to stage the faults")
    faults = [SlotCorruption(tick=corrupt_tick, slot=0),
              StragglerTicks(tick=slow_tick, n_ticks=STRAGGLER_TICKS,
                             factor=STRAGGLER_FACTOR),
              TickDeviceLoss(tick=loss_tick, device=1),
              HungTick(tick=hung_tick)]
    print(f"[{tag}] (b) retire ticks {done}; faults {faults}")

    # (c) the faulted run, P=3 -> 2 -> 1, consuming its weights as the
    #     CLI's --fault path does: the same seed's weights made anew
    injector = FaultInjector(faults)
    kernels = _kernel_fns()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    for fn in kernels.values():
        fn.launches = 0
    with TickLog() as ticks:
        res = serve_resilient(cfg, params, reqs, P=P, clock=None,
                              faults=injector, consume_params=True,
                              log=lambda m: print(f"[{tag}] {m}"), **kw)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    del params
    s_c = _serve_line(tag, "(c) serve_resilient P=3 -> 2 -> 1, faulted", res)
    for r in res["recoveries"]:
        print(f"[{tag}] recovery {r.kind}:{r.p_from}->{r.p_to} at tick "
              f"{r.tick}: re-admitted {r.n_readmitted}; detect "
              f"{r.detect_s * 1e3:.3f} ms, replan {r.replan_s * 1e3:.3f} ms, "
              f"remap {r.remap_s * 1e3:.3f} ms, readmit "
              f"{r.readmit_s * 1e3:.3f} ms, resume {r.resume_s * 1e3:.3f} ms")
    for i in res["incarnations"]:
        print(f"[{tag}] incarnation P={i['P']} {i['status']}: {i['ticks']} "
              f"ticks, {i['tokens']} tokens in {i['seconds']:.3f} s = "
              f"{i['tokens'] / i['seconds']:.2f} tokens/s, stage runs "
              f"{i['stage_runs']}")
    derived = ticks.stage_runs()
    want = ticks.launches(cfg)
    fired = sorted(injector._fired)
    acts = res["health_actions"]
    window = [a for t, a in acts
              if slow_tick <= t < slow_tick + STRAGGLER_TICKS]
    when = {rid: rec.done_tick for rid, rec in res["finished"].items()}
    print(f"[{tag}] events {[type(e['fault']).__name__ for e in res['events']]}"
          f", faults fired {fired}; counts {res['counts']}; health actions "
          f"{acts} (window {slow_tick}-{slow_tick + STRAGGLER_TICKS - 1}: "
          f"{window}); non-finite logits: accepted "
          f"{res['nonfinite_logits']}, stale {res['stale_nonfinite_logits']}")
    print(f"[{tag}] completed before the loss (tick {loss_tick}): "
          f"{sorted(r for r, t in when.items() if t < loss_tick)}, between: "
          f"{sorted(r for r, t in when.items() if loss_tick <= t < hung_tick)}"
          f", after the hung tick ({hung_tick}): "
          f"{sorted(r for r, t in when.items() if t >= hung_tick)}")
    print(f"[{tag}] launches {launches} (derived from each engine's "
          f"injections {[(p, k, r) for p, k, r in derived]}: {want}); "
          f"max_memory_allocated across the recoveries "
          f"{peak / 2 ** 30:.3f} GiB ({before / 2 ** 30:.3f} GiB allocated "
          f"before: the LM's weights, which the first engine consumes)")
    kinds = [(r.kind, r.p_from, r.p_to) for r in res["recoveries"]]
    if res["outcomes"] != {r.rid: "completed" for r in reqs}:
        fail(f"{tag}: outcomes {res['outcomes']}")
    if _streams(res) != oracle:
        bad = [r for r in oracle if _streams(res).get(r) != oracle[r]]
        fail(f"{tag}: streams of requests {bad} differ from P=1's")
    if kinds != [("device_loss", 3, 2), ("hung_tick", 2, 1)] or not all(
            r.n_readmitted >= 1 for r in res["recoveries"]):
        fail(f"{tag}: recoveries {res['recoveries']}")
    if res["counts"]["retries"] < sum(
            r.n_readmitted for r in res["recoveries"]) + 1:
        fail(f"{tag}: retries {res['counts']['retries']}")
    if len(res["events"]) != 3 or fired != [0, 1, 2, 3]:
        fail(f"{tag}: events {res['events']}, fired {fired}")
    if "checkpoint_now" not in window or "restart" not in \
            window[window.index("checkpoint_now"):]:
        fail(f"{tag}: the straggler window's actions {window}")
    if res["nonfinite_logits"]:
        fail(f"{tag}: {res['nonfinite_logits']} accepted waves had "
             "non-finite logits")
    if [(p, r) for p, _, r in derived] != [
            (i["P"], i["stage_runs"]) for i in res["incarnations"]]:
        fail(f"{tag}: stage runs {res['incarnations']} != derived {derived}")
    if launches != want:
        fail(f"{tag}: kernel launches {launches} != derived {want}")
    out = {"serve_resilient": launches}
    del res, res_a, res_b, res_b2
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI's overload path: bursty arrivals, deadlines, a queue bound
    argv = SERVE_ARGV + BURSTY_ARGV       # later flags win
    for fn in kernels.values():
        fn.launches = 0
    with TickLog() as ticks:
        cli = serve_main(argv)
    launches = {k: fn.launches for k, fn in kernels.items()}
    want = ticks.launches(cfg)
    res, breqs = cli["result"], cli["requests"]
    del cli
    c = res["counts"]
    rids = {r.rid for r in breqs}
    print(f"[{tag}-cli] {' '.join(BURSTY_ARGV)}: counts {c}; outcomes "
          f"{dict(sorted(res['outcomes'].items()))}; occupied slots "
          f"{res['occupied_slots']}; launches {launches} (derived {want}); "
          f"non-finite logits: accepted {res['nonfinite_logits']}, stale "
          f"{res['stale_nonfinite_logits']}")
    if (set(res["outcomes"]) != rids
            or set(res["finished"]) | set(res["dropped"]) != rids
            or set(res["finished"]) & set(res["dropped"])
            or sum(c[k] for k in ("completed", "expired", "shed", "failed"))
            != len(breqs) or res["occupied_slots"]):
        fail(f"{tag}-cli: not every request in exactly one terminal state")
    if res["nonfinite_logits"] or res["stale_nonfinite_logits"]:
        fail(f"{tag}-cli: non-finite logits on a fault-free run")
    if launches != want:
        fail(f"{tag}-cli: kernel launches {launches} != derived {want}")
    done_reqs = [dataclasses.replace(r, arrival_s=0.0, deadline=None)
                 for r in breqs if r.rid in res["finished"]]
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    eng = PipelinedEngine(cfg, params, P=1, **kw)
    ref = _streams(eng.serve(done_reqs, clock=None))
    del eng
    same = all(res["finished"][r.rid].tokens == ref[r.rid]
               for r in done_reqs)
    print(f"[{tag}-cli] {len(done_reqs)} completed streams == a P=1 "
          f"clock=None run's: {same}")
    if not same:
        fail(f"{tag}-cli: completed streams differ from the P=1 run's")
    out["serve_bursty"] = launches
    del params, lm, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_batched(torch):
    """24. Single-host batched serving (``--pipelined 0`` through
    ``main``): full-width tinyllama-1.1b, bf16, 4 prompts of 512 tokens,
    32 new tokens, greedy.  Gates: finite logits, flash launches one per
    layer in the one prefill call, rmsnorm two per layer per call
    (prefill and 31 decode steps); then fp32, 2 layers: ``serve_batched``'s
    logits, fused against plain, within phase 4's 1e-3 over the steps whose
    earlier tokens agree (the bf16 prefill's flash shape is among phase
    3's cases, held against ``attention_ref`` in both dtypes).  Prints
    prefill ms, decode ms per token against
    the weight-read bound and the peak, and the same of a warm re-run.
    Returns the launches."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.serve import serve_batched
    from repro_torch.models import LM
    from repro_torch.tree import tree_leaves
    tag = "serve-batched"
    gc.collect()
    torch.cuda.empty_cache()
    kernels = _kernel_fns()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    out = serve_main(BATCHED_ARGV)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    cfg, res, params = out["config"], out["result"], out["params"]
    B, S = out["prompts"].shape
    steps = res["decode_steps"]
    want = serve_launches(cfg, 1, steps)
    head = params["embed"].get("head", params["embed"]["tokens"])
    nbytes = sum(a.numel() * a.element_size()
                 for a in tree_leaves(params["layers"])) \
        + head.numel() * head.element_size()
    bound = hbm_ms(nbytes)
    dec = res["decode_s"] / steps * 1e3
    toks = res["tokens"]
    print(f"[{tag}] {cfg.name} full width bf16, batch {B} x {S} prompt "
          f"tokens, {toks.shape[1]} new (greedy): prefill "
          f"{res['prefill_s'] * 1e3:.2f} ms, decode {dec:.3f} ms a token "
          f"(bound: {nbytes / 1e9:.2f} GB of layer and head weights read "
          f"once = {bound:.3f} ms at 3.35 TB/s), "
          f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; launches "
          f"{launches} (derived {want}); logits finite: {res['finite']}; "
          f"tokens[0] {toks[0].tolist()}")
    if tuple(toks.shape) != (B, 32) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{tag}: tokens {tuple(toks.shape)}")
    if launches != want:
        fail(f"{tag}: kernel launches {launches} != derived {want}")
    if not res["finite"]:
        fail(f"{tag}: non-finite logits")
    # the same call again, warm (its launches are not the main path's)
    warm = serve_batched(out["lm"], params, out["prompts"], toks.shape[1])
    print(f"[{tag}] warm re-run, same weights and prompts: prefill "
          f"{warm['prefill_s'] * 1e3:.2f} ms, decode "
          f"{warm['decode_s'] / steps * 1e3:.3f} ms a token "
          f"({warm['decode_s'] / steps * 1e3 / bound:.1f}x the bound); "
          f"tokens equal to the first run's: "
          f"{bool(warm['tokens'].equal(toks))}")
    del out, params, res, warm
    gc.collect()
    torch.cuda.empty_cache()
    # fp32, full width, 2 layers: fused against plain
    import dataclasses
    cfg32 = dataclasses.replace(cfg, num_layers=2, param_dtype="float32",
                                compute_dtype="float32")
    fused = LM(cfg32, kernels="fused", device="cuda")
    plain = LM(cfg32, kernels="plain", device="cuda")
    p32 = fused.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(3))
    got = serve_batched(fused, p32, prompts, 8, keep_logits=True)
    ref = serve_batched(plain, p32, prompts, 8, keep_logits=True)
    same = (got["tokens"] == ref["tokens"]).all(dim=0).tolist() + [False]
    n = same.index(False) + 1        # steps whose earlier tokens agree
    worst = max(max_err(a, b) for a, b in zip(got["logits"][:n],
                                              ref["logits"][:n]))
    print(f"[{tag}] fp32 full width 2 layers, batch {B} x {S}: fused vs "
          f"plain logits over {min(n, 8)} steps: max|d|={worst:.3e} "
          f"(tol 1e-3); tokens equal: {bool(got['tokens'].equal(ref['tokens']))}")
    if not worst <= 1e-3:
        fail(f"{tag}: fused and plain backends disagree on fp32 logits")
    del fused, plain, p32, got, ref
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 25. the compressed wire, the compressed shared-gradient sum and the
#     quantized offload shipment
# ---------------------------------------------------------------------------

# |loss_4 - phase 6's loss_4| of 25b: the card read 0.0088 in three runs
# (PR 24's chip runs 1, 3 and 5, NVIDIA H100 80GB HBM3, 700.00 W), the
# same bits each time (tinyllama's steps repeat bitwise); the bound is a
# few times that
WIRE_INT8_LOSS_TOL = 0.03
# steps of the 25a and 25c runs (4 before phase 27 needed the time): 25a
# is held bitwise against phase 6's first WIRE_STEPS steps, 25c's
# shipment against phase 11's.  25b keeps phase 6's 4 steps: after one
# update its loss gate read 0.0154 (2 steps, NVIDIA H100 80GB HBM3,
# 700.00 W), too close to the bound set at step 4 to tell a faulty wire
WIRE_STEPS = 2
WIRE_INT8_STEPS = 4
EF_BYTES_TINYLLAMA = 0.524e9     # fp32 EF: embed 65.5 M + head 65.5 M + norm
# 25d: the card against the CPU, same wire on both.  Block leaves: per
# leaf max |d| / max |cpu|, a few times each wire's reading (PR 24's chip
# runs 1, 3, 5, NVIDIA H100 80GB HBM3, 700.00 W: bf16 wire 3.246e-3,
# where an ulp of difference at a bf16 rounding edge moves an element one
# bf16 step; int8 wire 7.26e-7, no code moved).  Shared leaves (through
# the int8 sum) and the error feedback, element by element in codes of
# the leaf's shared scale (one code is 1/127 of the largest partial):
# on the int8 wire only an ulp at a rounding edge moves an element, one
# code in the sum and in that stage's residual, so at most
# WIRE_CARD_CODES_MOVED elements move past CODE_NOISE; on the bf16 wire
# the boundaries themselves differ by bf16 steps, so every shared
# gradient moves a little (34,322 of 262,400 elements past CODE_NOISE,
# at most 1.996 codes, PR 24's chip run 6) and only the largest move is
# held, at twice that reading.
WIRE_CARD_BLOCK_TOL = {"bf16": 1e-2, "int8": 3e-6}
WIRE_CARD_CODE_TOL = {"bf16": 4, "int8": 2}
CODE_NOISE = 1e-3
WIRE_CARD_CODES_MOVED = {"bf16": None, "int8": 8}
WIRE_CARD_LOSS_TOL = 2e-6        # 4 ulps of the loss (read: 1 ulp and 0)


def _ring_reckoning(spec, wire):
    """The payload rings' bytes, reckoned from the task table: one
    payload a slot of every ring (fq, bq, act, rmt, the W stash's two),
    each the boundary ``[mbB, S, d]`` in bf16 or in int8 codes with an
    fp32 scale a row, beside the fp32 aux sum."""
    tab = spec.table
    n = tab.P * (tab.fq_depth + tab.bq_depth + sum(tab.act_depth.values())
                 + sum(tab.rmt_depth.values())
                 + 2 * sum(tab.wstash_depth.values()))
    x = spec.mbB * spec.S * spec.cfg.d_model
    per = {"bf16": 2 * x, "int8": x + 4 * spec.mbB}[wire] + 4
    return n, n * per


def _wire_run(torch, tag: str, steps: int = WIRE_STEPS, **plan):
    """Phase 6's run (tinyllama-1.1b at full width, chronos_zb, P=4, v=2,
    8 microbatches of one 2049-token sequence, seed 0, fused kernels)
    with ``plan``'s overrides, through ``train_pipeline``: the result,
    the launch counts, the peak from a reset after the weights are made,
    and whether every fp32 master moved."""
    import dataclasses

    from repro_torch.core.pipeline_runtime import init_pipeline_params
    from repro_torch.launch.steps import offload_kept
    from repro_torch.launch.train import train_pipeline
    from repro_torch.tree import tree_leaves
    tc0 = _train_config("tinyllama-1.1b")
    tc = dataclasses.replace(tc0, plan=dataclasses.replace(tc0.plan, **plan))
    spec = _spec_of(tc, 4)
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(tc.seed)
    params = init_pipeline_params(gen, tc.model, spec.layout, "cuda")
    kept = offload_kept(params, tc.plan)[0] if tc.plan.offload.enabled \
        else params
    before = [a.flatten()[:4096].to(torch.float32, copy=True)
              for a in tree_leaves(kept)]
    kernels = _kernel_fns()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    out = train_pipeline(tc, P=4, device="cuda", steps=steps, params=params,
                         log=lambda s: print(f"[{tag}] {s}", flush=True))
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    masters = tree_leaves(out["opt_state"]["master"])
    moved = all(not torch.equal(a, b.flatten()[:4096])
                for a, b in zip(before, masters))
    med = statistics.median(out["step_s"][1:])
    print(f"[{tag}] losses={out['losses']} grad_norms={out['grad_norms']} "
          f"step_s={out['step_s']}")
    print(f"[{tag}] median step {med * 1e3:.1f} ms, max_memory_allocated="
          f"{peak / 2 ** 30:.3f} GiB, payload rings "
          f"{out['wire']['ring_bytes'] / 2 ** 30:.4f} GiB "
          f"({out['wire']['wire']} wire), launches {launches}, fp32 masters "
          f"{'all moved' if moved else 'NOT all moved'}")
    res = {"out": out, "launches": launches, "peak": peak, "median_s": med,
           "moved": moved, "spec": spec}
    del params, kept, before, masters
    return res


def phase_train_wire(torch, base):
    """25a-c at full width (tinyllama-1.1b, phase 6's configuration),
    ``WIRE_STEPS`` steps each (25b ``WIRE_INT8_STEPS``):
    25a ``wire="bf16"`` (the exact wire at bf16 compute: losses and
    gradient norms bitwise phase 6's); 25b ``wire="int8"`` with
    ``grad_compression="int8_ef"`` (finite, every ``ef_abs_max`` within
    half its grid step, masters moved, phase 6's launches, the last loss
    within ``WIRE_INT8_LOSS_TOL`` of phase 6's at that step; the rings'
    bytes, 25a's and
    25b's each equal to :func:`_ring_reckoning`); 25c phase 11's offload run with ``int8_ef`` (finite,
    phase 11's launches, a peak within phase 11's plus the EF's 0.524 GB
    plus 0.1 GiB; the shipped bytes beside phase 11's bf16 shipment, the
    copy's GB/s, ``collect_wait_s``).  Returns the launch counts per
    path."""
    b6 = base["tinyllama-1.1b"]
    b11 = b6["offload_run"]
    finite = (lambda r: all(math.isfinite(x) for x in
                            r["out"]["losses"] + r["out"]["grad_norms"]))
    n = WIRE_STEPS
    b6_launches = {k: n * v for k, v in b6["per_step"].items()}
    b11_launches = {k: n * v for k, v in b11["per_step"].items()}

    a = _wire_run(torch, "train-wire-bf16", wire="bf16")
    same = (a["out"]["losses"] == b6["losses"][:n]
            and a["out"]["grad_norms"] == b6["grad_norms"][:n])
    print(f"[train-wire-bf16] 25a against phase 6's first {n} steps: "
          f"losses and gradient norms "
          f"{'bitwise equal' if same else 'DIFFER'} (phase 6 "
          f"{b6['losses'][:n]}, {b6['grad_norms'][:n]}); median step "
          f"{a['median_s'] * 1e3:.1f} ms (phase 6 {b6['median_s'] * 1e3:.1f}"
          f"), peak {a['peak'] / 2 ** 30:.3f} GiB (phase 6 "
          f"{b6['peak'] / 2 ** 30:.3f})")
    if not same:
        fail("25a: the bf16 wire at bf16 compute departs from phase 6")
    if a["launches"] != b6_launches:
        fail(f"25a: launches {a['launches']} != phase 6's {b6_launches}")
    bf16_rings = a["out"]["wire"]["ring_bytes"]
    n_slots, want = _ring_reckoning(a["spec"], "bf16")
    print(f"[train-wire-bf16] 25a: payload rings {bf16_rings} B against "
          f"{want} B reckoned ({n_slots} slots)")
    if bf16_rings != want:
        fail(f"25a: payload rings {bf16_rings} B, reckoned {want}")
    launches = {"train_wire_bf16": a["launches"]}
    del a
    done("train-wire bf16 (25a)")

    n8 = WIRE_INT8_STEPS
    b6_int8_launches = {k: n8 * v for k, v in b6["per_step"].items()}
    b = _wire_run(torch, "train-wire-int8", steps=n8, wire="int8",
                  grad_compression="int8_ef")
    w = b["out"]["wire"]
    moves = sum(abs(x - y) for x, y in zip(b6["losses"][1:n8],
                                           b6["losses"][:n8 - 1]))
    d_n = abs(b["out"]["losses"][-1] - b6["losses"][n8 - 1])
    _, int8_want = _ring_reckoning(b["spec"], "int8")
    print(f"[train-wire-int8] 25b: payload rings {w['ring_bytes']} B "
          f"({w['ring_bytes'] / 2 ** 30:.4f} GiB, int8 codes plus fp32 "
          f"scales; reckoned {int8_want} B: the bf16 wire's halved, plus "
          f"4 B of scale a row) against the bf16 wire's {bf16_rings} B "
          f"({bf16_rings / 2 ** 30:.4f} GiB): x{bf16_rings / w['ring_bytes']:.4f}")
    for k, e in w["ef_abs_max"].items():
        s_ = w["psum_scale"][k]
        print(f"[train-wire-int8] ef_abs_max {k}: {e:.6e} against half its "
              f"grid step {s_ / 2:.6e}")
    print(f"[train-wire-int8] loss_{n8} {b['out']['losses'][-1]} against "
          f"phase 6's {b6['losses'][n8 - 1]}: |d| {d_n:.6f} (bound "
          f"{WIRE_INT8_LOSS_TOL}; phase 6's loss moved {moves:.4f} over its "
          f"steps); median step "
          f"{b['median_s'] * 1e3:.1f} ms against phase 6's "
          f"{b6['median_s'] * 1e3:.1f} ms ({b['median_s'] / b6['median_s']:.4f}"
          f"x); peak {b['peak'] / 2 ** 30:.3f} GiB against phase 6's "
          f"{b6['peak'] / 2 ** 30:.3f} GiB")
    if not finite(b):
        fail("25b: non-finite loss or gradient norm")
    bad = [k for k, e in w["ef_abs_max"].items()
           if not e <= w["psum_scale"][k] / 2 + 1e-6]
    if bad:
        fail(f"25b: error feedback past half a grid step in {bad}")
    if not b["moved"]:
        fail("25b: an fp32 master did not move")
    if b["launches"] != b6_int8_launches:
        fail(f"25b: launches {b['launches']} != phase 6's "
             f"{b6_int8_launches}")
    if w["ring_bytes"] != int8_want:
        fail(f"25b: payload rings {w['ring_bytes']} B, reckoned {int8_want}")
    if not d_n <= WIRE_INT8_LOSS_TOL:
        fail(f"25b: loss_{n8} departs from phase 6's by {d_n}")
    launches["train_wire_int8"] = b["launches"]
    del b, w                  # w holds the run's EF (0.524 GB): free it
    done("train-wire int8 (25b)")

    from repro_torch.configs.base import OffloadConfig
    c = _wire_run(torch, "train-offload-int8", grad_compression="int8_ef",
                  offload=OffloadConfig(enabled=True, num_offload_chunks=1))
    rep = c["out"]["offload"]
    limit = b11["peak"] + EF_BYTES_TINYLLAMA + 0.1 * 2 ** 30
    print(f"[train-offload-int8] 25c: median step {c['median_s'] * 1e3:.1f} "
          f"ms (phase 11 {b11['median_s'] * 1e3:.1f}); peak "
          f"{c['peak'] / 2 ** 30:.3f} GiB against phase 11's "
          f"{b11['peak'] / 2 ** 30:.3f} (limit {limit / 2 ** 30:.3f}); "
          f"shipped {rep['bytes_down']} B ({rep['bytes_down'] / 1e9:.4f} "
          f"GB: int8 codes plus scales) against phase 11's bf16 "
          f"{b11['bytes_down']} B ({b11['bytes_down'] / 1e9:.4f} GB); copy "
          f"ms {[round(t, 2) for t in rep['copy_down_ms']]} (GB/s "
          f"{[round(g, 2) for g in rep['copy_down_gbps']]}; phase 11 "
          f"{[round(g, 2) for g in b11['copy_down_gbps']]}); host update s "
          f"{[round(t, 3) for t in rep['host_update_s']]}; collect_wait_s "
          f"{rep['collect_wait_s']:.3f} (phase 11 "
          f"{b11['collect_wait_s']:.3f}); losses {c['out']['losses']} "
          f"(phase 11 {b11['losses']})")
    if not finite(c):
        fail("25c: non-finite loss or gradient norm")
    if c["launches"] != b11_launches:
        fail(f"25c: launches {c['launches']} != phase 11's "
             f"{b11_launches}")
    if not c["peak"] <= limit:
        fail(f"25c: peak {c['peak']} past phase 11's plus the EF ({limit})")
    if rep["submits"] != n:
        fail(f"25c: {rep['submits']} submits in {n} steps")
    launches["train_offload_int8"] = c["launches"]
    del c
    gc.collect()
    torch.cuda.empty_cache()
    done("train-offload int8 (25c)")
    return launches


def phase_wire_checks(torch):
    """25d: the reduced tinyllama in fp32, chronos P=2 v=2 m=4 (two
    sequences of 17 tokens a microbatch), ``wire`` bf16 and int8 with
    the int8 shared-gradient sum, 3 steps with the error feedback
    threaded: the gradients, the loss and the EF on the card against the
    same calls on the CPU (the tier-1 pairs hold the CPU against JAX);
    then the int8 wire's codes and scales for a 2048 x 2048 bf16 payload,
    its read-back, and ``compressed_sum`` on the card against the CPU,
    bitwise."""
    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                                   init_psum_ef,
                                                   make_pipeline_spec,
                                                   make_train_grads_fn,
                                                   wire_decode, wire_encode)
    from repro_torch.optim import compressed_sum
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_reduced("tinyllama-1.1b")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 2, 17))
    for wire in ("bf16", "int8"):
        spec = make_pipeline_spec(cfg, P=2, v=2, m=4, microbatch=2,
                                  seq_len=17, schedule="chronos",
                                  kernels="fused", wire=wire,
                                  grad_psum_bits=8)
        res = {}
        for dev in ("cpu", "cuda"):
            params = tree_map(lambda a: a.to(dev), init_pipeline_params(
                torch.Generator().manual_seed(0), cfg, spec.layout, "cpu"))
            fn = make_train_grads_fn(spec, dev)
            ef = init_psum_ef(spec, params)
            batch = {"tokens": torch.from_numpy(toks).to(dev)}
            for _ in range(3):
                g, met, ef = fn(params, batch, ef)
            res[dev] = (tree_map(lambda a: a.cpu(), g), float(met["loss"]),
                        tree_map(lambda a: a.cpu(), ef),
                        [float(x) for x in tree_leaves(met["psum_scale"])])
        got, want = res["cuda"][0], res["cpu"][0]
        e_blk = max(float((a.float() - b.float()).abs().max()
                          / (b.float().abs().max() + 1e-12))
                    for a, b in zip(tree_leaves(got["blocks"]),
                                    tree_leaves(want["blocks"])))
        # shared gradients and EF rows, |d| in codes of the CPU's scale
        scales = res["cpu"][3]
        shared = [k for k in sorted(want) if k != "blocks"]
        codes = torch.cat(
            [((a - b).abs() / s_).flatten() for a, b, s_ in zip(
                [x for k in shared for x in tree_leaves(got[k])],
                [x for k in shared for x in tree_leaves(want[k])], scales)]
            + [((a - b).abs() / s_).flatten() for a, b, s_ in zip(
                tree_leaves(res["cuda"][2]), tree_leaves(res["cpu"][2]),
                scales)])
        c_max = float(codes.max())
        moved = int((codes > CODE_NOISE).sum())
        d_loss = abs(res["cuda"][1] - res["cpu"][1])
        print(f"[wire-check] reduced tinyllama fp32 chronos P=2 v=2 m=4, "
              f"wire {wire} + int8_ef, step 3: card vs CPU per-leaf max "
              f"|d| / max |cpu| of the blocks {e_blk:.3e} (tol "
              f"{WIRE_CARD_BLOCK_TOL[wire]}); shared gradients and EF: max "
              f"|d| {c_max:.4f} codes (tol {WIRE_CARD_CODE_TOL[wire]}), "
              f"{moved} of {codes.numel()} elements past {CODE_NOISE} codes "
              f"(tol {WIRE_CARD_CODES_MOVED[wire]}); |d loss| {d_loss:.3e} "
              f"(tol {WIRE_CARD_LOSS_TOL})")
        most = WIRE_CARD_CODES_MOVED[wire]
        if not (e_blk <= WIRE_CARD_BLOCK_TOL[wire]
                and c_max <= WIRE_CARD_CODE_TOL[wire]
                and (most is None or moved <= most)
                and d_loss <= WIRE_CARD_LOSS_TOL):
            fail(f"25d: the {wire} wire on the card departs from the CPU")
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = (torch.randn((1, 2048, 2048), generator=gen)
         * torch.logspace(-2, 1, 2048)).to(torch.bfloat16)
    q_c, s_c = wire_encode(x, "int8")
    q_g, s_g = wire_encode(x.cuda(), "int8")
    y_c = wire_decode(q_c, s_c, torch.bfloat16)
    y_g = wire_decode(q_g, s_g, torch.bfloat16)
    parts = [torch.randn((2048, 2048), generator=gen) * (i + 1)
             for i in range(2)]
    ef = torch.randn((2, 2048, 2048), generator=gen) * 1e-3
    r_c, e_c = compressed_sum([p.clone() for p in parts], ef.clone(), 8)
    r_g, e_g = compressed_sum([p.cuda() for p in parts], ef.cuda(), 8)
    same = (torch.equal(q_c, q_g.cpu()) and torch.equal(s_c, s_g.cpu())
            and torch.equal(y_c, y_g.cpu()) and torch.equal(r_c, r_g.cpu())
            and torch.equal(e_c, e_g.cpu()))
    print(f"[wire-check] int8 wire of a [1, 2048, 2048] bf16 payload (codes, "
          f"scale, read-back) and compressed_sum of two [2048, 2048] fp32 "
          f"partials with EF: card vs CPU "
          f"{'bitwise equal' if same else 'DIFFER'}")
    if not same:
        fail("25d: the quantizer on the card departs from the CPU's")


# ---------------------------------------------------------------------------
# 26. the roofline: counted steps against the dry run on the meta device
# ---------------------------------------------------------------------------

# tag -> one more step of a training run counted on the card (phases 6,
# 8, 10, 15a), and the serving decode tick of phase 4
COUNTED = {}
COUNTED_PHASE = {"train": "6", "train-mamba2": "8",
                 "train-single-none": "10", "train-single-chronos": "10",
                 "train-single-full": "10", "train-qwen2-moe": "15a"}


def counted_configs():
    """tag -> ``(TrainConfig, P)`` of each step phase 26 holds a card
    count against: the configurations phases 6, 8, 10 and 15a train
    (``P`` None: ``train()``'s step)."""
    return {
        "train": (_train_config("tinyllama-1.1b"), 4),
        "train-mamba2": (_train_config("mamba2-2.7b",
                                       layers=MAMBA2_TRAIN_LAYERS), 4),
        **{f"train-single-{name}": (_single_config("tinyllama-1.1b", rc, 4),
                                    None)
           for name, rc in single_modes().items()},
        "train-qwen2-moe": (_train_config("qwen2-moe-a2.7b", layers=4), 2)}


def _dry_counts(conn) -> None:
    """The child of :class:`DryRun`: counts every step of
    :func:`counted_configs` on the meta device
    (``repro_torch.launch.dryrun``) and sends ``("ok", tag -> (tc, count,
    seconds))``, or ``("error", traceback)``."""
    try:
        import torch
        torch.set_num_threads(1)
        from repro_torch.launch import dryrun
        out = {}
        for tag, (tc, P) in counted_configs().items():
            t0 = time.perf_counter()
            if P is None:
                wc = dryrun.count_single_step(tc.model, tc.shape, tc.plan,
                                              tc.optimizer)
            else:
                wc = dryrun.count_pipeline_step(tc.model, tc.shape, tc.plan,
                                                tc.optimizer, P)
            out[tag] = (tc, wc, time.perf_counter() - t0)
        conn.send(("ok", out))
    except BaseException:
        import traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class DryRun:
    """Phase 26's dry run on the meta device, in a child process started
    before phase 6: it needs no card, so its host seconds pass while the
    training phases keep the card busy.  A daemon: it ends with this
    process."""

    def __init__(self):
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=False)
        self.t0 = time.perf_counter()
        self.proc = ctx.Process(target=_dry_counts, args=(child,),
                                daemon=True)
        self.proc.start()
        child.close()

    def result(self, timeout: float = 600.0):
        """tag -> (tc, count, seconds); how long this call waited."""
        t0 = time.perf_counter()
        if not self.conn.poll(timeout):
            self.proc.kill()
            fail(f"the dry run on meta sent nothing in {timeout:.0f} s")
        try:
            status, out = self.conn.recv()
        except EOFError:
            status, out = "error", f"the child exited {self.proc.exitcode}"
        self.proc.join(30)
        if status != "ok":
            fail(f"the dry run on meta failed:\n{out}")
        return out, time.perf_counter() - t0


def count_train_step(torch, tag: str, tc, P, params, opt_state,
                     median_s: float) -> None:
    """One more step of ``tc`` on the trained state, under
    ``repro_torch.roofline.count_work`` (never a timed step: every op
    pays a Python call): the pipeline step over ``P`` virtual stages, or
    with ``P`` None ``train()``'s step.  Kept for phase 26 beside the
    run's median step time."""
    from repro_torch.launch.steps import (make_pipeline_train_step,
                                          make_train_step)
    from repro_torch.roofline import count_work
    mbB = tc.plan.microbatch_size
    if P is None:
        m = tc.shape.global_batch // mbB
        step, _ = make_train_step(tc.model, tc.plan, tc.optimizer, m,
                                  device="cuda")
    else:
        step, m, mbB, _ = make_pipeline_train_step(
            tc.model, tc.shape, tc.plan, tc.optimizer, P=P, device="cuda")
    batch = _profile_batch(torch, tc, m, mbB)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with count_work() as wc:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    took = time.perf_counter() - t0
    COUNTED[tag] = {"count": wc, "tc": tc, "P": P, "median_s": median_s,
                    "count_s": took}
    print(f"[roofline] {tag}: one more step counted on the card in "
          f"{took:.2f} s (untimed; the median step {median_s * 1e3:.1f} "
          f"ms): {wc.flops} FLOP, {wc.bytes_traffic_raw} B")


def count_decode_tick(torch, eng) -> None:
    """One decode tick of phase 4's warm engine (slot 0, the last cache
    position) counted on the card; its bytes must cover the weights
    ``decode_bound_ms`` reads."""
    from repro_torch.roofline import count_work
    from repro_torch.serve.scheduler import DECODE, Injection
    inj = Injection(op=DECODE, slot=0, pos=eng.max_seq - 1, tokens=(1,),
                    sample=True)
    torch.cuda.synchronize()
    with count_work() as wc:
        eng.tick(inj)
        torch.cuda.synchronize()
    wbytes, wms = decode_bound_ms(eng)
    COUNTED["serve-decode-tick"] = {"count": wc, "weight_bytes": wbytes,
                                    "weight_ms": wms}
    print(f"[roofline] serve decode tick ({eng.cfg.name}, P={eng.P}, "
          f"{eng.max_seq} cache positions): counted {wc.bytes_traffic_raw} "
          f"B ({hbm_ms(wc.bytes_traffic_raw) * 1e3:.1f} us at 3.35 TB/s), "
          f"{wc.flops} FLOP; decode_bound_ms's weights {wbytes} B "
          f"({wms * 1e3:.1f} us): counted / weights "
          f"{wc.bytes_traffic_raw / wbytes:.3f}")
    if wc.bytes_traffic_raw < wbytes:
        fail(f"the counted decode tick moves {wc.bytes_traffic_raw} B, "
             f"less than its weights' {wbytes} B")


def phase_roofline(torch, smi: str, dry: DryRun) -> None:
    """26. Each step counted on the card (phases 6, 8, 10, 15a) against
    the dry run of the same configuration and plan on the meta device
    (``repro_torch.launch.dryrun``, run by ``dry`` since phase 6: each
    distinct op once, multiplied by the task table): the configurations
    equal, FLOPs and every kernel's calls, FLOPs and bytes equal exactly;
    printed beside ``model_flops_for``, ``useful_ratio``, the three
    roofline terms, the dominant one and ``mfu`` against the run's median
    step, with the card's name and power limit; then the decode tick's
    bytes against its weights (gated in phase 4)."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline.analysis import (CollectiveStats,
                                               cost_to_roofline, mfu,
                                               model_flops_for)
    want = set(COUNTED_PHASE)
    if not want <= set(COUNTED):
        fail(f"roofline: no counted step for {sorted(want - set(COUNTED))}")
    counts, waited = dry.result()
    print(f"[roofline] the dry run on meta (a child process since phase 6) "
          f"took {sum(c[2] for c in counts.values()):.2f} s; phase 26 "
          f"waited {waited:.2f} s for it")
    for tag in COUNTED_PHASE:
        e = COUNTED[tag]
        tc, P, wc = e["tc"], e["P"], e["count"]
        dry_tc, meta, dry_s = counts[tag]
        if dry_tc != tc:
            fail(f"roofline {tag}: the dry run's configuration is not the "
                 f"one the card trained")
        if P is None:
            mbB = tc.plan.microbatch_size
            coll = CollectiveStats({}, {})
            what = (f"train() m={tc.shape.global_batch // mbB} mbB={mbB}, "
                    f"recompute {tc.plan.recompute.mode}")
        else:
            coll = dryrun.collective_stats(_spec_of(tc, P))
            what = f"{tc.plan.schedule} P={P} v={tc.plan.num_chunks}"
        mf = model_flops_for(tc.model, tc.shape, "train")
        roof = cost_to_roofline(wc, coll, 1, mf)
        u = mfu(mf, e["median_s"])
        print(f"[roofline] {smi} | phase {COUNTED_PHASE[tag]} {tag} "
              f"{tc.model.name} ({tc.model.num_layers} layers, {what}): "
              f"counted on the card {wc.flops} FLOP, "
              f"{wc.bytes_traffic_raw / 1e9:.3f} GB "
              f"({wc.score_bytes / 1e9:.3f} GB score-class); dry run on "
              f"meta {meta.flops} FLOP, {meta.bytes_traffic_raw / 1e9:.3f} GB "
              f"in {dry_s:.2f} s; model_flops_for {mf:.6g}; useful_ratio "
              f"{roof.useful_ratio:.4f}; t_compute "
              f"{roof.t_compute * 1e3:.1f} ms, t_memory "
              f"{roof.t_memory * 1e3:.1f} ms, t_collective "
              f"{roof.t_collective * 1e3:.2f} ms "
              f"({coll.total_bytes / 1e9:.3f} GB across virtual stages); "
              f"dominant {roof.dominant}; "
              f"mfu {100 * u:.3f}% at the median step "
              f"{e['median_s'] * 1e3:.1f} ms (bf16 peak 989 TFLOP/s)")
        print(f"[roofline]   {tag} kernels (calls, FLOP, B), card: "
              f"{dict(sorted(wc.kernels.items()))}; meta: "
              f"{dict(sorted(meta.kernels.items()))}")
        if wc.flops != meta.flops:
            fail(f"roofline {tag}: the card counted {wc.flops} FLOP, the "
                 f"dry run {meta.flops}")
        if wc.kernels != meta.kernels:
            fail(f"roofline {tag}: kernel_cost sums differ, card "
                 f"{wc.kernels}, meta {meta.kernels}")
    d = COUNTED["serve-decode-tick"]
    print(f"[roofline] {smi} | phase 4 decode tick: counted "
          f"{d['count'].bytes_traffic_raw} B against decode_bound_ms's "
          f"weights {d['weight_bytes']} B")


# ---------------------------------------------------------------------------
# 27. the pipeline stages as torch.distributed ranks
# ---------------------------------------------------------------------------

def release_host_cache(torch) -> str:
    """Return the page-locked blocks torch's caching host allocator keeps
    free (the earlier phases' offload, checkpoint and staging copies; it
    rounds each to a power of two and never frees one by itself) to the
    system, so that the mesh phases' eight processes have the host's
    memory; the offload runner's host buffers (the process's one set,
    ``optim.offload.release_host_buffers``) are dropped first.  Returns a
    line: the pinned bytes held before and after, or that this torch has
    no binding for it."""
    from repro_torch.optim.offload import release_host_buffers
    release_host_buffers()          # the offload runner's one set
    fn = getattr(torch._C, "_host_emptyCache", None)

    def held():
        return torch.cuda.host_memory_stats().get("allocated_bytes.current",
                                                  0)
    before = held()
    if fn is None:
        return (f"page-locked host cache {_gib(before)} GiB kept (no "
                f"binding to release it in torch {torch.__version__})")
    fn()
    return f"page-locked host cache {_gib(before)} -> {_gib(held())} GiB"


RANKS_P = 4
# phase 6's tinyllama-1.1b cut to 8 of its 22 layers (22 before phase 31
# needed the time: 72.5 s, 34.6 s of it the four fresh processes' first
# step, on a fast host)
RANKS_LAYERS = 8
RANKS_STEPS = 2          # the first a warm-up (3 before phase 30)
RANKS_SYNC_STEPS = 1     # the synchronous exchange's run (2 before phase
#                          30; warm, after the overlapped run)
RANKS_TC = 0.25          # nominal P2P latency (grains) of comm_calibration
RANKS_TIMEOUT = 300      # seconds for the phase's one spawn
RANKS_CHECK = dict(layers=4, m=8, seq=257)   # the fp32 check (P=4, v=2)
CHECK_REL = 2e-5         # phase 7's fp32 tolerance, where processes differ


def _ranks_check_spec():
    """The fp32 check's spec: full width cut to 4 layers, chronos_zb,
    P=4, v=2, 8 microbatches of one 257-token sequence, fused kernels,
    the overlapped table."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.pipeline_runtime import make_pipeline_spec
    c = RANKS_CHECK
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              num_layers=c["layers"], param_dtype="float32",
                              compute_dtype="float32")
    return make_pipeline_spec(cfg, P=RANKS_P, v=2, m=c["m"], microbatch=1,
                              seq_len=c["seq"], schedule="chronos_zb",
                              kernels="fused", overlap=True)


def _ranks_check_inputs(torch, spec, device):
    """The check's weights (seed 0) and tokens (seed 1) on ``device``."""
    from repro_torch.core.pipeline_runtime import init_pipeline_params
    params = init_pipeline_params(
        torch.Generator(device=device).manual_seed(0), spec.cfg,
        spec.layout, device)
    c = RANKS_CHECK
    tokens = torch.randint(0, spec.cfg.vocab_size, (c["m"], 1, c["seq"]),
                           device=device, generator=torch.Generator(
                               device=device).manual_seed(1))
    return params, {"tokens": tokens}


def _ranks_fp32_check(torch, mesh, ref_path):
    """On one rank: the check's gradients over the mesh (this rank's
    column) against the one-device executor's run in the parent
    (``ref_path``, read by memory map: the rank's column only), leaf by
    leaf: bitwise, or the max relative error.  Where they differ, the
    one-device executor runs here too, to tell whether it gives the
    parent's bits in this process (``here``)."""
    from repro_torch.core.pipeline_runtime import (make_train_grads_fn,
                                                   rank_params)
    from repro_torch.tree import tree_leaves
    spec = _ranks_check_spec()
    dev, r = mesh.device, mesh.rank
    params, batch = _ranks_check_inputs(torch, spec, dev)
    g, met = make_train_grads_fn(spec, dev, mesh=mesh)(
        rank_params(params, r), batch)

    def leaves(tree, blocks):
        return blocks + [a for k, v in tree.items() if k != "blocks"
                         for a in tree_leaves(v)]

    def column(tree):                  # a one-device tree at this rank
        return leaves(tree, [a[r] for a in tree_leaves(tree["blocks"])])

    def compare(want):
        want = [w.to(dev) for w in want]
        return ([bool(torch.equal(a, b)) for a, b in
                 zip(got, want, strict=True)],
                [_rel_err(a, b) for a, b in zip(got, want)])
    got = leaves(g, tree_leaves(g["blocks"]))
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    same, rel = compare(column(ref["g"]))
    out = {"loss": float(met["loss"]), "parent_loss": float(ref["loss"]),
           "same": same, "rel": rel, "here": None}
    if all(same) and out["loss"] == out["parent_loss"]:
        return out
    g1, m1 = make_train_grads_fn(spec, dev)(params, batch)
    here = compare(column(g1))
    out["here"] = {
        "same": here[0], "rel": here[1],
        "loss_same": bool(torch.equal(met["loss"], m1["loss"])),
        "same_as_parent": all(torch.equal(a, b.to(dev)) for a, b in
                              zip(column(g1), column(ref["g"])))}
    return out


def _train_ranks_body(mesh, tc, steps, sync_steps, ref_path):
    """What each of phase 27's ranks runs: ``steps`` steps with the
    overlapped exchange (the main path, launches counted), then
    ``sync_steps`` with the synchronous one, then the fp32 check against
    the parent's one-device gradients in ``ref_path``."""
    import torch

    from repro_torch.launch.train import train_rank

    def log(line):
        print(f"[train-ranks] {line}", flush=True)
    over = train_rank(mesh, tc, RANKS_P, {"overlap": True, "steps": steps,
                                          "log": log})
    gc.collect()
    torch.cuda.empty_cache()
    sync = train_rank(mesh, tc, RANKS_P, {"overlap": False,
                                          "steps": sync_steps, "log": log})
    gc.collect()
    torch.cuda.empty_cache()
    return {"overlap": over, "sync": sync,
            "check": _ranks_fp32_check(torch, mesh, ref_path)}


def rank_predictions(tc=None) -> dict:
    """What phase 27 predicts before it runs, reckoned on the host (no
    card): each stage's peak by ``MemoryModel`` (its model state, the
    embedding and head spread over the stages, plus the stage's peak
    activations), the same with each rank's whole replica of the shared
    leaves, the bytes the exchange should move a step
    (``stage_crossing_sends``) and the shared-gradient all-reduce's
    (``collective_stats``), and ``comm_calibration``'s makespans."""
    from repro_torch.core.analysis import MemoryModel
    from repro_torch.core.schedule import comm_calibration
    from repro_torch.core.schedules import get_schedule
    from repro_torch.launch.dryrun import collective_stats
    tc = tc or _train_config("tinyllama-1.1b", layers=RANKS_LAYERS)
    cfg, plan = tc.model, tc.plan
    spec = _spec_of(tc, RANKS_P)
    sched = get_schedule(plan.schedule, RANKS_P, spec.table.m,
                         v=plan.num_chunks)
    mm = MemoryModel.build(cfg)
    L, tokens = cfg.num_layers, plan.microbatch_size * tc.shape.seq_len
    state = mm.model_state(L, RANKS_P, 1)
    replica = mm.params_embed * mm.state_bytes_per_param * (
        1 - 1 / RANKS_P)
    acts = [a * mm.m_a(tokens, L)
            for a in sched.peak_activation(per_stage=True)]
    coll = collective_stats(spec)
    return {"stage_bytes": [state + a for a in acts],
            "stage_bytes_replica": [state + replica + a for a in acts],
            "exchange_bytes": coll.bytes_by_kind["collective-permute"],
            "sends": coll.count_by_kind["collective-permute"],
            "allreduce_bytes": coll.bytes_by_kind["all-reduce"],
            "calibration": comm_calibration(sched, RANKS_TC)}


def phase_train_ranks(torch, smi: str):
    """27: phase 6's configuration cut to ``RANKS_LAYERS`` layers trained
    as ``RANKS_P`` processes on the card (gloo through page-locked host memory, the ``host`` transport):
    NCCL's refusal of two ranks on one device first; then one spawn whose
    ranks each run ``RANKS_STEPS`` steps with the overlapped exchange,
    ``RANKS_SYNC_STEPS`` with the synchronous one, and the fp32 check.
    Gates: finite losses equal on every rank, the shared replicas equal
    after every step, every rank's launches summed equal to the table's
    count (each op runs on one rank; fused AdamW once a leaf on every
    rank), the 4-layer fp32 gradients bitwise the one-device executor's
    run in this process (or, only where that executor gives other bits
    in the ranks' processes and the ranks equal it there bitwise, within
    phase 7's 2e-5 relative).  Prints each rank's step time, peak beside
    ``MemoryModel``'s stage prediction, bytes moved and wait share, and
    the two step times beside ``comm_calibration`` scaled by the
    synchronous step.  Returns the summed launch counts."""
    import tempfile

    from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                                   make_train_grads_fn)
    from repro_torch.launch.mesh import spawn
    from repro_torch.tree import tree_leaves, tree_map
    tc = _train_config("tinyllama-1.1b", layers=RANKS_LAYERS)
    spec = _spec_of(tc, RANKS_P)
    pred = rank_predictions(tc)
    try:
        spawn(RANKS_P, _train_ranks_body, backend="nccl", device="cuda")
        fail("27: NCCL accepted four ranks on one card")
    except RuntimeError as e:
        if "host transport" not in str(e):
            fail(f"27: NCCL refused with another message: {e}")
        print(f"[train-ranks] NCCL, {RANKS_P} ranks on one card: refused "
              f"({e})")
    with tempfile.TemporaryDirectory(prefix="ranks_check_") as tmp:
        # the fp32 check's one-device gradients, for the ranks to read
        cspec = _ranks_check_spec()
        params, batch = _ranks_check_inputs(torch, cspec, "cuda")
        g1, m1 = make_train_grads_fn(cspec, "cuda")(params, batch)
        ref_path = os.path.join(tmp, "one_device.pt")
        torch.save(tree_map(lambda a: a.cpu(), {"g": g1, "loss": m1["loss"]}),
                   ref_path)
        del g1, m1, params, batch
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[train-ranks] {release_host_cache(torch)} (this process, "
              f"before the spawn)")
        t0 = time.perf_counter()
        outs = spawn(RANKS_P, _train_ranks_body,
                     args=(tc, RANKS_STEPS, RANKS_SYNC_STEPS, ref_path),
                     backend="gloo", device="cuda",
                     timeout_s=RANKS_TIMEOUT)
        wall = time.perf_counter() - t0
    over = [o["overlap"] for o in outs]
    sync = [o["sync"] for o in outs]
    print(f"[train-ranks] {smi} | {RANKS_P} processes on one card, "
          f"{tc.model.name} full width bf16 ({tc.model.num_layers} layers), "
          f"{spec.table.name} v={tc.plan.num_chunks} m={spec.table.m} "
          f"mbB={spec.mbB} seq {spec.S}, gloo through page-locked host "
          f"memory; spawn, {RANKS_STEPS} overlapped + {RANKS_SYNC_STEPS} "
          f"synchronous steps and the fp32 check in {wall:.1f} s")
    losses = over[0]["losses"]
    if not all(math.isfinite(x) for x in losses + over[0]["grad_norms"]):
        fail(f"27: non-finite loss or gradient norm {losses}")
    if any(o["losses"] != losses for o in over) or \
            any(o["losses"] != sync[0]["losses"] for o in sync):
        fail("27: the ranks disagree on the loss")
    if not all(all(o["replicas_equal"]) for o in over + sync):
        fail(f"27: shared replicas differ across ranks "
             f"{[o['replicas_equal'] for o in over + sync]}")
    print(f"[train-ranks] losses {losses}; gradient norms "
          f"{over[0]['grad_norms']}; shared replicas equal on every rank "
          f"after every step")
    # the launches: every op of the table runs on one rank; each rank
    # updates its own tree (the full tree's leaf count) with fused AdamW
    n_leaves = len(tree_leaves(init_pipeline_params(
        None, tc.model, spec.layout, "meta")))
    per_step = expected_train_launches(spec, RANKS_P * n_leaves)
    want = {k: RANKS_STEPS * n for k, n in per_step.items()}
    summed = {k: sum(o["launches"][k] for o in over) for k in want}
    print(f"[train-ranks] launches by rank "
          f"{[o['launches'] for o in over]}, summed {summed} (the table: "
          f"{want})")
    if summed != want:
        fail(f"27: launches {summed} != {want}")
    if any(not o["launches"][k] for o in over
           for k in ("rmsnorm_rows", "flash_attention_fwd",
                     "fused_adamw_flat")):
        fail("27: a rank launched no kernel of the path")
    med = [statistics.median(o["step_s"][1:]) for o in over]
    med_sync = [statistics.median(o["step_s"]) for o in sync]
    for r, o in enumerate(over):
        ex = o["exchange"]
        waits = ex["wait_s"][1:]
        share = sum(waits) / sum(o["step_s"][1:])
        share_sync = sum(sync[r]["exchange"]["wait_s"]) \
            / sum(sync[r]["step_s"])
        print(f"[train-ranks] {smi} | rank {r}: step {med[r] * 1e3:.1f} ms "
              f"(steps {[round(x * 1e3, 1) for x in o['step_s']]}; "
              f"synchronous {med_sync[r] * 1e3:.1f} ms, "
              f"{[round(x * 1e3, 1) for x in sync[r]['step_s']]}); "
              f"max_memory_allocated {o['peak_bytes'] / 2 ** 30:.3f} GiB "
              f"(weights and optimizer state "
              f"{o['static_bytes'] / 2 ** 30:.3f}) against MemoryModel's "
              f"stage {r} "
              f"{pred['stage_bytes'][r] / 2 ** 30:.3f} GiB "
              f"({pred['stage_bytes_replica'][r] / 2 ** 30:.3f} with the "
              f"whole shared replica); exchange {ex['bytes_sent'][-1]} B "
              f"sent, {ex['bytes_recv'][-1]} B received, "
              f"{ex['messages'][-1]} messages a step, all-reduce "
              f"{ex['reduced_bytes'][-1]} B; waits on the exchange "
              f"{[round(w * 1e3, 1) for w in waits]} ms, {100 * share:.1f}% "
              f"of steps 2-{RANKS_STEPS} (synchronous: "
              f"{100 * share_sync:.1f}%)")
    sent = sum(o["exchange"]["bytes_sent"][-1] for o in over)
    reduced = sum(o["exchange"]["reduced_bytes"][-1] for o in over)
    print(f"[train-ranks] a step's exchange over the ranks: {sent} B in "
          f"{sum(o['exchange']['messages'][-1] for o in over) // 2} sends "
          f"(the dry run: {pred['exchange_bytes']:.0f} B in "
          f"{pred['sends']} collective-permute sends); all-reduces "
          f"{reduced} B (the dry run's shared-gradient all-reduce "
          f"{pred['allreduce_bytes']:.0f} B, plus the loss, count and "
          f"norm scalars)")
    cal = pred["calibration"]
    scale = max(med_sync) / cal["sync"]
    print(f"[train-ranks] {smi} | step (slowest rank's median): "
          f"overlapped {max(med) * 1e3:.1f} ms, synchronous "
          f"{max(med_sync) * 1e3:.1f} ms; comm_calibration at tc "
          f"{RANKS_TC} grains {cal} scaled by the synchronous step "
          f"({scale * 1e3:.2f} ms a grain): zero "
          f"{cal['zero'] * scale * 1e3:.1f} ms, async {cal['async'] * scale * 1e3:.1f} ms, sync "
          f"{cal['sync'] * scale * 1e3:.1f} ms (printed, not gated)")
    # the fp32 check: each rank against the one-device executor run in
    # this process (and, where they differ, in the rank's own)
    for r, o in enumerate(outs):
        c = o["check"]
        print(f"[train-ranks] fp32 check, rank {r} ({RANKS_CHECK}): "
              f"{sum(c['same'])} of {len(c['same'])} gradient leaves "
              f"bitwise the one-device executor's (max rel "
              f"{max(c['rel']):.3e}); loss {c['loss']} against "
              f"{c['parent_loss']}")
        if all(c["same"]) and c["loss"] == c["parent_loss"]:
            continue
        differ = [i for i, x in enumerate(c["same"]) if not x]
        h = c["here"]
        print(f"[train-ranks] rank {r}: the one-device executor in the "
              f"rank's process: {sum(h['same'])} leaves bitwise the rank's "
              f"(max rel {max(h['rel']):.3e}), its gradients "
              f"{'equal' if h['same_as_parent'] else 'differ from'} this "
              f"process's")
        if not h["same_as_parent"] and all(h["same"]) and h["loss_same"] \
                and max(c["rel"]) <= CHECK_REL:
            print(f"[train-ranks] rank {r}: leaves {differ} differ from this "
                  f"process's run as the one-device executor in the rank's "
                  f"process does (another library algorithm there), within "
                  f"{CHECK_REL} relative")
            continue
        fail(f"27: rank {r}'s fp32 gradients differ from the one-device "
             f"executor's (leaves {differ})")
    return summed


# ---------------------------------------------------------------------------
# 28. data and tensor parallelism beside the pipe axis
# ---------------------------------------------------------------------------

MESH_SHAPE = (2, 2, 2)   # pp x dp x tp: eight processes on the card
# full width, cut in depth: tinyllama-1.1b (phases 28-29) and mamba2-2.7b
# at 4 layers, v=2; qwen2-moe-a2.7b (phase 30) at 2 layers, one a stage
# (v=1): at 4 layers (v=2) the eight ranks' state leaves less than 10 GB
# of the card (PERF.md, section 6)
# phase 31: whisper-base at its full depth (6 decoder and 6 encoder
# layers), one a stage (v=1); paligemma-3b at 4 of its 18 layers, v=2
MESH_LAYERS = {"tinyllama-1.1b": 4, "mamba2-2.7b": 4, "qwen2-moe-a2.7b": 2,
               "whisper-base": 6, "paligemma-3b": 4}
MESH_CHUNKS = {"tinyllama-1.1b": 2, "mamba2-2.7b": 2, "qwen2-moe-a2.7b": 1,
               "whisper-base": 1, "paligemma-3b": 2}
# tokens a sequence where not TRAIN_SEQ: whisper's decoder context of
# 448 positions (phase 19's length), each sequence with its 1500 frames
MESH_SEQ = {"whisper-base": 449}
# qwen2-moe's vocabulary held here: half of its 151936 rows (the share of
# a second pair of vocab-parallel chips).  Every rank of the pipeline
# holds the embedding and the head with their whole fp32 state over dp,
# as the reference lays them out (both tables replicated over pp,
# src/repro/core/pipeline_runtime.py:370-372 and 392-393; no fsdp on
# them, src/repro/launch/steps.py:405-413): at the whole vocabulary the
# eight ranks' weights, gradients, state and logits come to 65.3 GiB
# (``family_reckoning``), which with eight CUDA contexts and the steps'
# activations leaves no room on the card.  An eighth in the fp32 checks,
# whose one-process references hold the whole fp32 tree.
MOE_VOCAB_SHARE = {"main": 2, "check": 8}
MESH_STEPS = 2           # the first a warm-up
MESH_TIMEOUT = 600       # seconds for the phases' one spawn (28-30)
MESH_CHECK = dict(m=2, seq=257)    # the fp32 checks


def _mesh_model(arch: str, check: bool = False, single: bool = False):
    """``arch`` at full width as the mesh phases run it: ``MESH_LAYERS``
    layers (``single``: ``train()``'s, ``SINGLE_MESH_LAYERS`` where it
    names the config), an MoE config's vocabulary cut to its share
    (``MOE_VOCAB_SHARE``); ``check``: fp32, and the check's share."""
    import dataclasses

    from repro_torch.configs import get_config
    layers = MESH_LAYERS[arch]
    if single:
        layers = SINGLE_MESH_LAYERS.get(arch, layers)
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, vocab_size=cfg.vocab_size
                                  // MOE_VOCAB_SHARE["check" if check
                                                     else "main"])
    if check:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    return cfg


def _mesh_config(arch: str = "tinyllama-1.1b"):
    """Phase 28's (and 30's and 31's) configuration: ``_mesh_model(arch)``,
    chronos_zb P=2 at ``MESH_CHUNKS`` chunks a stage, one 2049-token
    (``MESH_SEQ``) sequence a dp rank a microbatch (a global microbatch
    of dp sequences), m=4."""
    import dataclasses
    tc = _train_config(arch, seq=MESH_SEQ.get(arch, TRAIN_SEQ),
                       num_microbatches=4, num_chunks=MESH_CHUNKS[arch])
    return dataclasses.replace(tc, model=_mesh_model(arch))


def _mesh_shape(arch: str):
    """The ``(pp, dp, tp)`` layout ``arch`` trains on in phases 28-31."""
    return ENCVLM_SHAPE.get(arch, MESH_SHAPE)


def _mesh_check_spec(global_batch: bool, arch: str = "tinyllama-1.1b"):
    """The fp32 check's spec: ``_mesh_model(arch, True)``, chronos_zb,
    P=2, ``MESH_CHUNKS`` chunks a stage, m=2 microbatches of one 257-token
    sequence a dp rank of ``_mesh_shape(arch)`` (``global_batch``: the
    one-process run's dp), fused kernels, the overlapped table."""
    from repro_torch.core.pipeline_runtime import make_pipeline_spec
    c = MESH_CHECK
    pp, dp, _ = _mesh_shape(arch)
    return make_pipeline_spec(_mesh_model(arch, True), P=pp,
                              v=MESH_CHUNKS[arch], m=c["m"],
                              microbatch=dp if global_batch else 1,
                              seq_len=c["seq"], schedule="chronos_zb",
                              kernels="fused", overlap=True)


def _embeds(torch, cfg, lead, device):
    """A VLM's ``patch_embeds`` or an encoder-decoder's ``frame_embeds``
    (``lead`` + ``[P or T, d]``, N(0, 1) fp32, seed 2), else none."""
    gen = torch.Generator(device=device).manual_seed(2)
    out = {}
    for key, n in (("patch_embeds", cfg.vision and cfg.vision.num_patches),
                   ("frame_embeds", cfg.encdec and cfg.encdec.num_frames)):
        if n:
            out[key] = torch.randn(tuple(lead) + (n, cfg.d_model),
                                   generator=gen, device=device)
    return out


def _mesh_check_inputs(torch, spec, device, dp: int = MESH_SHAPE[1]):
    """The check's weights (seed 0) and global batch of ``dp`` sequences
    a microbatch: tokens (seed 1), and the config's patch or frame
    embeddings (seed 2)."""
    from repro_torch.core.pipeline_runtime import init_pipeline_params
    params = init_pipeline_params(
        torch.Generator(device=device).manual_seed(0), spec.cfg,
        spec.layout, device)
    c = MESH_CHECK
    tokens = torch.randint(0, spec.cfg.vocab_size,
                           (c["m"], dp, c["seq"]), device=device,
                           generator=torch.Generator(
                               device=device).manual_seed(1))
    return params, {"tokens": tokens,
                    **_embeds(torch, spec.cfg, (c["m"], dp), device)}


def _mesh_reference(torch, path, arch: str = "tinyllama-1.1b",
                    device: str = "cuda"):
    """The one-process executor's fp32 gradients and loss on the check's
    global batch of ``arch``, saved to ``path`` with every F op's MoE
    dropped fractions (:class:`_DroppedRecorder`); returns each leaf's
    largest |element|."""
    from repro_torch.core.pipeline_runtime import make_train_grads_fn
    from repro_torch.tree import tree_leaves, tree_map
    spec = _mesh_check_spec(True, arch)
    params, batch = _mesh_check_inputs(torch, spec, device,
                                       _mesh_shape(arch)[1])
    with _DroppedRecorder() as rec:
        g, met = make_train_grads_fn(spec, device)(params, batch)
    del params
    g = tree_map(lambda a: a.cpu(), g)
    torch.save({"g": g, "loss": met["loss"].cpu(),
                "dropped": sorted(rec.rec.items())}, path)
    return [float(a.abs().max()) for a in tree_leaves(g)]


def _mesh_fp32_check(torch, mesh, ref_path, zero_stage: int = 1,
                     arch: str = "tinyllama-1.1b"):
    """On one rank: the check's gradients of ``arch`` over the mesh (its
    pp column, tp shard; at ``zero_stage`` 3 the dp slices of the fsdp
    block leaves) against the same part of the one-process executor's
    gradients in ``ref_path`` (cut by the rank's ``RankShard``): each
    leaf's max |difference|, for the parent to divide by the whole
    leaf's largest element; and the MoE layers' dropped fractions of
    this rank's F ops beside the one-process run's of its pp column."""
    from repro_torch.core.pipeline_runtime import (RankShard,
                                                   make_train_grads_fn,
                                                   rank_params)
    from repro_torch.tree import tree_leaves
    spec = _mesh_check_spec(False, arch)
    dev, p = mesh.device, mesh.coord("pp")
    shard = RankShard(spec.cfg, spec.layout, mesh.shape, mesh.rules,
                      mesh.coords, zero_stage)
    params, batch = _mesh_check_inputs(torch, spec, dev, mesh.dp)
    params = rank_params(params, p, shard)
    gc.collect()
    torch.cuda.empty_cache()       # the whole tree each rank drew
    with _DroppedRecorder() as rec:
        g, met = make_train_grads_fn(spec, dev, mesh=mesh,
                                     shard=shard)(params, batch)
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    want = shard.cut(ref["g"], p)
    diff = [float((a - b.to(dev)).abs().max())
            for a, b in zip(tree_leaves(g), tree_leaves(want), strict=True)]
    return {"loss": float(met["loss"]), "parent_loss": float(ref["loss"]),
            "diff": diff, "paths": ["/".join(map(str, q))
                                    for q in shard.paths],
            "dropped": sorted(rec.rec.items()),
            "parent_dropped": [(tuple(k), v) for k, v in ref["dropped"]
                               if k[0] == p]}


def _warm_blas(torch):
    """One bf16 and one fp32 product, forward and backward, with and
    without a bias, so that cuBLAS's and cuBLASLt's workspaces (held by
    the caching allocator for the life of the process) exist before the
    first measured run and count in every run's base alike."""
    for dt in (torch.bfloat16, torch.float32):
        a = torch.ones(64, 64, device="cuda", dtype=dt, requires_grad=True)
        b = torch.ones(64, device="cuda", dtype=dt)
        (a @ a + torch.nn.functional.linear(a, a, b)).sum().backward()
    torch.cuda.synchronize()


def _train_mesh_body(mesh, tc, steps, ref_path, single_ref_path, fam_refs,
                     ckdir):
    """What each of phase 28's ranks runs: ``steps`` steps on the mesh
    (the main path, launches counted), then the fp32 check; then phase
    29's cases in the same processes: ``ZERO3_STEPS`` steps of ``tc`` at
    ZeRO stage 3 and its fp32 check, and on the same eight processes
    regrouped as ``SINGLE_MESH_SHAPE`` ``train()`` for each ``(stage,
    steps)`` of ``SINGLE_MESH_RUNS`` and its fp32 check; then phase 30's
    and phase 31's (:func:`_families_body`, ``fam_refs`` their
    references); then phase 32's (:func:`_offload_mesh_body`, its
    checkpoints in ``ckdir``).  ``base``: the
    bytes allocated just before each run (after ``_warm_blas``), which
    the memory readings are taken over."""
    import dataclasses

    import torch

    from repro_torch.launch.train import train_rank, train_single_rank

    def log(line):
        print(f"[train-mesh] {line}", flush=True)

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        release_host_cache(torch)
        return torch.cuda.memory_allocated()
    _warm_blas(torch)
    base = {"train": free()}
    out = train_rank(mesh, tc, MESH_SHAPE[0], {"overlap": True,
                                               "steps": steps, "log": log})
    free()
    res = {"train": out, "check": _mesh_fp32_check(torch, mesh, ref_path),
           "base": base}
    base["zero3"] = free()
    t0 = time.perf_counter()
    tc3 = dataclasses.replace(tc, plan=dataclasses.replace(tc.plan,
                                                           zero_stage=3))
    res["zero3"] = train_rank(mesh, tc3, MESH_SHAPE[0], {
        "overlap": True, "steps": ZERO3_STEPS, "log": log})
    free()
    res["zero3_check"] = _mesh_fp32_check(torch, mesh, ref_path,
                                          zero_stage=3)
    free()
    res["zero3_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = mesh.regroup(SINGLE_MESH_SHAPE)
    res["single"], res["single_check"] = {}, {}
    for z, n in SINGLE_MESH_RUNS:
        base[z] = free()
        res["single"][z] = train_single_rank(single, _single_mesh_config(z),
                                             {"steps": n, "log": log})
        free()
        res["single_check"][z] = _single_mesh_fp32_check(
            torch, single, single_ref_path, z)
    res["single_s"] = time.perf_counter() - t0
    res["families"] = _families_body(mesh, single, log, free, base,
                                     fam_refs)
    res["encvlm"] = _families_body(mesh, single, log, free, base, fam_refs,
                                   ENCVLM)
    res["offload"] = _offload_mesh_body(mesh, ref_path, ckdir, log, free,
                                        base)
    return res


ZERO3_STEPS = 2          # phase 29 (A): stage 3 on MESH_SHAPE (the first
#                          a warm-up; step 2's loss checks the sliced update)
SINGLE_MESH_SHAPE = (1, 4, 2)   # phase 29 (B): the same eight processes
# (ZeRO stage, steps) of train() in turn: stage 3 first, its step the
# processes' warm-up on this layout, then stage 1 warm; each with its fp32
# check (stage 3 ran 2 steps before phase 30)
SINGLE_MESH_RUNS = ((3, 1), (1, 1))
SINGLE_MESH_CHECK = dict(seq=257)    # the fp32 checks
# microbatches of one sequence a dp rank in a train() step: phase 29 (B)'s
# tinyllama 2, phases 30 and 31 (C)'s one (30's qwen2-moe step
# reduce-scatters the experts' gradients over dp each microbatch: 26.2 GB
# at 2)
SINGLE_MESH_M = {"tinyllama-1.1b": 2, "mamba2-2.7b": 1, "qwen2-moe-a2.7b": 1,
                 "whisper-base": 1, "paligemma-3b": 1}
# layers of train() on the mesh where not MESH_LAYERS: phase 31 (C)'s
# paligemma-3b
SINGLE_MESH_LAYERS = {"paligemma-3b": 2}


def _single_mesh_config(zero_stage: int, check: bool = False,
                        arch: str = "tinyllama-1.1b"):
    """Phase 29 (B) (and 30 and 31 (C)): ``_mesh_model(arch, check,
    single=True)`` through ``train()`` on ``SINGLE_MESH_SHAPE``:
    ``SINGLE_MESH_M`` microbatches of one 2049-token (``MESH_SEQ``)
    sequence a dp rank a step, chronos recompute over 2 chunks, at
    ``zero_stage``; ``check``: the fp32 check's (257 tokens)."""
    import dataclasses

    from repro_torch.configs.base import RecomputeConfig
    tc = _single_config(arch, RecomputeConfig("chronos"), 1)
    tc = dataclasses.replace(
        tc, model=_mesh_model(arch, check, single=True),
        shape=dataclasses.replace(tc.shape, global_batch=SINGLE_MESH_M[arch]
                                  * SINGLE_MESH_SHAPE[1],
                                  seq_len=MESH_SEQ.get(arch, TRAIN_SEQ)),
        plan=dataclasses.replace(tc.plan, zero_stage=zero_stage))
    if not check:
        return tc
    return dataclasses.replace(tc, shape=dataclasses.replace(
        tc.shape, seq_len=SINGLE_MESH_CHECK["seq"]))


def _single_mesh_check_inputs(torch, tc, device):
    """The (B) check's weights (seed 0) and global batch (seed 1:
    ``[m, dp, seq]`` tokens; seed 2: the config's patch or frame
    embeddings)."""
    from repro_torch.models import LM
    dp = SINGLE_MESH_SHAPE[1]
    m = tc.shape.global_batch // dp
    params = LM(tc.model, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(0, tc.model.vocab_size, (m, dp, tc.shape.seq_len),
                           device=device, generator=torch.Generator(
                               device=device).manual_seed(1))
    return params, {"tokens": tokens,
                    **_embeds(torch, tc.model, (m, dp), device)}, m


def _single_mesh_reference(torch, path, arch: str = "tinyllama-1.1b",
                           device: str = "cuda"):
    """The one-process ``train()`` step's fp32 gradient sums and loss sum
    on the (B) check's inputs of ``arch``, saved to ``path``; returns each
    leaf's largest |element|."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.tree import tree_leaves
    tc = _single_mesh_config(1, check=True, arch=arch)
    params, batch, m = _single_mesh_check_inputs(torch, tc, device)
    step, _ = make_train_step(tc.model, tc.plan, tc.optimizer, m,
                              device=device)
    g, lsum = step.grads(params, batch)
    del params
    torch.save({"g": [a.cpu() for a in tree_leaves(g)],
                "lsum": float(lsum)}, path)
    return [float(a.abs().max()) for a in tree_leaves(g)]


def _single_mesh_fp32_check(torch, mesh, ref_path, zero_stage: int,
                            arch: str = "tinyllama-1.1b"):
    """On one rank of ``SINGLE_MESH_SHAPE``: the (B) check's gradient
    sums of ``arch`` (the rank's state slices) against the same part of
    the one-process step's: each leaf's max |difference|, and the loss
    sums."""
    from repro_torch.launch.steps import make_train_step
    tc = _single_mesh_config(zero_stage, check=True, arch=arch)
    params, batch, m = _single_mesh_check_inputs(torch, tc, mesh.device)
    step, _ = make_train_step(tc.model, tc.plan, tc.optimizer, m,
                              device=mesh.device, mesh=mesh)
    shard = step.shard
    params = shard.cut(params)
    gc.collect()
    torch.cuda.empty_cache()       # the whole tree each rank drew
    g, lsum = step.grads(params, batch)
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    diff = [float((a - shard.zero_slice(shard.cut_leaf(
        b.to(mesh.device), i), i)).abs().max())
        for i, (a, b) in enumerate(zip(g, ref["g"], strict=True))]
    return {"lsum": float(lsum), "parent_lsum": ref["lsum"], "diff": diff,
            "paths": ["/".join(map(str, q)) for q in shard.paths]}


def mesh_predictions(tc, shape=MESH_SHAPE) -> dict:
    """What phase 28 predicts before it runs, reckoned on the host:
    ``MemoryModel``'s stage prediction at (pp, tp) of ``shape`` (the
    model state over pp x tp, the embedding and head over tp and spread
    over the stages, plus the stage's peak activations over tp), the same
    with each rank's whole tp shard of the shared leaves, and the bytes a
    step hands to collectives (``collective_stats`` on the mesh)."""
    from repro_torch.core.analysis import MemoryModel
    from repro_torch.core.schedules import get_schedule
    from repro_torch.launch.dryrun import collective_stats
    pp, dp, tp = shape
    cfg, plan = tc.model, tc.plan
    spec = _spec_of(tc, pp)
    sched = get_schedule(plan.schedule, pp, spec.table.m, v=plan.num_chunks)
    mm = MemoryModel.build(cfg, tp=tp)
    L, tokens = cfg.num_layers, plan.microbatch_size * tc.shape.seq_len
    state = mm.model_state(L, pp, tp)
    replica = mm.params_embed / tp * mm.state_bytes_per_param * (1 - 1 / pp)
    acts = [a * mm.m_a(tokens, L)
            for a in sched.peak_activation(per_stage=True)]
    state3 = mm.model_state(L, pp, tp, dp_shard=dp)
    return {"stage_bytes": [state + a for a in acts],
            "stage_bytes_replica": [state + replica + a for a in acts],
            "model_state": state, "model_state_zero3": state3,
            "stage_bytes_zero3": [state3 + a for a in acts],
            "collectives": collective_stats(spec, dp, tp, update=True),
            "collectives_zero3": collective_stats(spec, dp, tp, update=True,
                                                  zero_stage=3)}


def single_mesh_predictions() -> dict:
    """Phase 29 (B)'s reckoning on the host: ``MemoryModel``'s model
    state of the 4-layer tinyllama on (pp 1, tp 2) with the state over
    dp (ZeRO-1) and with everything over dp (``dp_shard=dp``, ZeRO-3),
    and the bytes a step hands to collectives at each stage
    (``train_collective_stats``)."""
    from repro_torch.core.analysis import MemoryModel
    from repro_torch.launch.dryrun import train_collective_stats
    _, dp, tp = SINGLE_MESH_SHAPE
    tc = _single_mesh_config(1)
    mm = MemoryModel.build(tc.model, tp=tp)
    L = tc.model.num_layers
    m = tc.shape.global_batch // dp
    return {"model_state": {1: mm.model_state(L, 1, tp),
                            3: mm.model_state(L, 1, tp, dp_shard=dp)},
            "m": m,
            "collectives": {z: train_collective_stats(
                tc.model, m=m, mbB=1, seq_len=tc.shape.seq_len, dp=dp,
                tp=tp, zero_stage=z) for z, _ in SINGLE_MESH_RUNS}}


def phase_train_mesh(torch, smi: str):
    """28: ``_mesh_config()`` trained on a pp 2 x dp 2 x tp 2 mesh of
    eight processes on the card (gloo through page-locked host memory):
    ``MESH_STEPS`` steps, then the fp32 check.  Gates: finite losses
    equal on every rank; the dp replicas (every weight) and the
    tp-replicated leaves (weights and masters) bitwise equal after every
    step, and the shared leaves over pp; launches summed over the ranks
    equal to the table's count x dp x tp for RMSNorm and flash, one
    fused-AdamW launch a leaf slice a rank a step; the bytes handed to
    collectives each step equal to ``collective_stats``' count, axis by
    axis (``by_axis``); the fp32 gradients of every rank's shard within phase 7's 2e-5
    relative of the one-process executor's (of the whole leaf's largest
    element).  Prints each rank's step time and peak beside
    ``MemoryModel``'s stage prediction at (pp 2, tp 2), the bytes moved
    per axis and the exchange's wait share; then phase 29
    (:func:`phase_zero3_checks`), whose cases run in the same spawn.
    Returns the launch counts by path."""
    import tempfile

    from repro_torch.core.pipeline_runtime import init_pipeline_params
    from repro_torch.launch.mesh import spawn
    from repro_torch.tree import tree_leaves
    pp, dp, tp = MESH_SHAPE
    n = pp * dp * tp
    tc = _mesh_config()
    spec = _spec_of(tc, pp)
    pred = mesh_predictions(tc)
    with tempfile.TemporaryDirectory(prefix="mesh_check_") as tmp:
        ref_path = os.path.join(tmp, "one_process.pt")
        ref_max = _mesh_reference(torch, ref_path)
        gc.collect()
        torch.cuda.empty_cache()
        single_ref = os.path.join(tmp, "one_process_train.pt")
        single_max = _single_mesh_reference(torch, single_ref)
        gc.collect()
        torch.cuda.empty_cache()
        # phases 30 and 31's one-process references
        fam_refs, fam_max = {}, {}
        for arch in FAMILIES + ENCVLM:
            fam_refs[arch] = {k: os.path.join(tmp, f"{arch}_{k}.pt")
                              for k in ("pipe", "single")}
            fam_max[arch] = {"pipe": _mesh_reference(
                torch, fam_refs[arch]["pipe"], arch)}
            gc.collect()
            torch.cuda.empty_cache()
            fam_max[arch]["single"] = _single_mesh_reference(
                torch, fam_refs[arch]["single"], arch)
            gc.collect()
            torch.cuda.empty_cache()
        print(f"[train-mesh] {release_host_cache(torch)} (this process, "
              f"before the spawn)")
        t0 = time.perf_counter()
        outs = spawn(n, _train_mesh_body,
                     args=(tc, MESH_STEPS, ref_path, single_ref, fam_refs,
                           os.path.join(tmp, "mesh_ckpt")),
                     shape=MESH_SHAPE, backend="gloo", device="cuda",
                     timeout_s=MESH_TIMEOUT)
        wall = time.perf_counter() - t0
    runs = [o["train"] for o in outs]
    print(f"[train-mesh] {smi} | {n} processes on one card, pp {pp} x dp "
          f"{dp} x tp {tp}, {tc.model.name} full width bf16 "
          f"({tc.model.num_layers} layers), {spec.table.name} "
          f"v={tc.plan.num_chunks} m={spec.table.m}, {spec.mbB} sequence "
          f"a dp rank a microbatch of {spec.S} positions, gloo through "
          f"page-locked host memory; spawn, {MESH_STEPS} steps and the "
          f"fp32 check in {wall:.1f} s")
    losses = runs[0]["losses"]
    if not all(math.isfinite(x) for x in losses + runs[0]["grad_norms"]):
        fail(f"28: non-finite loss or gradient norm {losses}")
    if any(o["losses"] != losses for o in runs):
        fail(f"28: the ranks disagree on the loss "
             f"{[o['losses'] for o in runs]}")
    if not all(all(o["replicas_equal"]) for o in runs):
        fail(f"28: replicas differ {[o['replica_checks'] for o in runs]}")
    print(f"[train-mesh] losses {losses}; gradient norms "
          f"{runs[0]['grad_norms']}; after every step the dp replicas, the "
          f"tp-replicated leaves and the shared leaves over pp bitwise "
          f"equal on every rank")
    n_leaves = len(tree_leaves(init_pipeline_params(
        None, tc.model, spec.layout, "meta")))
    per_step = expected_train_launches(spec, n_leaves)
    want = {k: MESH_STEPS * v * (n if k == "fused_adamw_flat" else dp * tp)
            for k, v in per_step.items()}
    summed = {k: sum(o["launches"][k] for o in runs) for k in want}
    print(f"[train-mesh] launches by rank {[o['launches'] for o in runs]}, "
          f"summed {summed} (the table x dp x tp; fused AdamW a leaf slice "
          f"a rank: {want})")
    if summed != want:
        fail(f"28: launches {summed} != {want}")
    if any(not o["launches"][k] for o in runs
           for k in ("rmsnorm_rows", "flash_attention_fwd",
                     "fused_adamw_flat")):
        fail("28: a rank launched no kernel of the path")
    coll = pred["collectives"]
    kb, kc = coll.bytes_by_kind, coll.count_by_kind
    for step in range(MESH_STEPS):
        got = {a: sum(o["exchange"]["axis_bytes"][step][a] for o in runs)
               for a in ("pp", "data", "model")}
        if got != coll.by_axis:
            fail(f"28: step {step} handed {got} B to collectives, "
                 f"collective_stats counts {coll.by_axis}")
    print(f"[train-mesh] bytes handed to collectives a step, over the "
          f"ranks, equal to collective_stats' count: pp "
          f"{coll.by_axis['pp']} (sends {int(kb['collective-permute'])}, "
          f"shared-gradient sum {int(kb['all-reduce'])}), data "
          f"{coll.by_axis['data']} (gradients {int(kb['all-reduce-dp'])},"
          f" ZeRO-1 all-gather {int(kb['all-gather-dp'])}), model "
          f"{coll.by_axis['model']} ({kc['all-reduce-tp']} "
          f"activation all-reduces)")
    for o in runs:
        r, co = o["rank"], o["coords"]
        med = statistics.median(o["step_s"][1:])
        share = sum(o["exchange"]["wait_s"][1:]) / sum(o["step_s"][1:])
        print(f"[train-mesh] {smi} | rank {r} (pp {co['pp']}, dp "
              f"{co['data']}, tp {co['model']}): step {med * 1e3:.1f} ms "
              f"(steps {[round(x * 1e3, 1) for x in o['step_s']]}); "
              f"max_memory_allocated {_gib(o['peak_bytes'])} GiB "
              f"(weights and optimizer state "
              f"{_gib(o['static_bytes'])}) against MemoryModel's "
              f"stage {co['pp']} at (pp {pp}, tp {tp}) "
              f"{pred['stage_bytes'][co['pp']] / 2 ** 30:.3f} GiB "
              f"({pred['stage_bytes_replica'][co['pp']] / 2 ** 30:.3f} with "
              f"the rank's whole shard of the shared leaves); bytes a step "
              f"{o['exchange']['axis_bytes'][-1]}; exchange waits "
              f"{100 * share:.1f}% of steps 2-{MESH_STEPS}")
    worst = _check_fp32("28", [o["check"] for o in outs], ref_max, "loss")
    print(f"[train-mesh] fp32 check ({MESH_CHECK}, {tc.model.num_layers} "
          f"layers, the global batch of "
          f"{dp} sequences a microbatch): every rank's gradient shard "
          f"within {worst:.3e} relative of the one-process executor's "
          f"(tol {CHECK_REL}); loss {outs[0]['check']['loss']} against "
          f"{outs[0]['check']['parent_loss']}")
    return {"train_mesh": summed,
            **phase_zero3_checks(smi, outs, tc, spec, pred, per_step,
                                 ref_max, single_max),
            **phase_families_checks(smi, outs, fam_max),
            **phase_families_checks(smi, outs, fam_max, ENCVLM, "31",
                                    "encvlm", "train-encvlm"),
            **phase_offload_mesh_checks(smi, outs, runs,
                                        [o["base"] for o in outs])}


def _gib(nbytes) -> str:
    """Bytes as GiB, three decimals."""
    return f"{nbytes / 2 ** 30:.3f}"


def _check_fp32(tag: str, checks, ref_max, loss_key: str):
    """Every rank's fp32 check within ``CHECK_REL`` of the one-process
    run (each leaf's max |difference| over the whole leaf's largest
    element, and the loss); returns the worst relative difference."""
    worst = 0.0
    for c in checks:
        rel = [d / max(m, 1e-30) for d, m in zip(c["diff"], ref_max)]
        worst = max(worst, max(rel))
        ours, theirs = c[loss_key], c["parent_" + loss_key]
        if abs(ours - theirs) > CHECK_REL * abs(theirs) \
                or max(rel) > CHECK_REL:
            fail(f"{tag}: rank fp32 gradients differ from the one-process "
                 f"run's: {loss_key} {ours} vs {theirs}, max rel "
                 f"{max(rel):.3e} at {c['paths'][rel.index(max(rel))]}")
    return worst


def phase_zero3_checks(smi: str, outs, tc, spec, pred, per_step, ref_max,
                       single_max):
    """29: what phase 28's eight processes ran after it.  (A) ``tc`` at
    ZeRO stage 3 on the same mesh (each rank holding its dp slice of
    every fsdp block leaf, gathered by each op): phase 28's gates (finite
    losses equal on every rank, the whole leaves' replicas equal,
    launches the table's x dp x tp, each step's bytes by axis
    ``collective_stats(zero_stage=3)``'s, fp32 gradient slices within
    ``CHECK_REL`` of the one-process executor's), and the losses within
    ``CHECK_REL`` of phase 28's stage-1 run on the same data.  (B)
    ``train()`` on the eight processes regrouped as
    ``SINGLE_MESH_SHAPE`` for each ``(stage, steps)`` of
    ``SINGLE_MESH_RUNS``: losses equal on every rank, the first step's
    equal across the stages bitwise (the later steps' gap is printed: a
    reduce-scatter of dp 4 bf16 operands may associate them by the
    message's size, a layer's at stage 3, a stacked leaf's at stage 1),
    replicas, each step's bytes ``train_collective_stats``', launches
    ``expected_single_launches`` a rank, the fp32 check at each stage
    against the one-process ``train()`` step.
    Prints each rank's peak and weights and state at each stage over the
    bytes allocated just before the run (its base), beside
    ``MemoryModel``.  Returns the launch counts by path."""
    from repro_torch.core.pipeline_runtime import init_pipeline_params
    from repro_torch.tree import tree_leaves
    pp, dp, tp = MESH_SHAPE
    n = pp * dp * tp
    runs1 = [o["train"] for o in outs]
    runs = [o["zero3"] for o in outs]
    losses = runs[0]["losses"]
    print(f"[train-zero3] {smi} | phase 28's {tc.model.name} "
          f"({tc.model.num_layers} layers) at ZeRO stage 3 on pp {pp} x dp "
          f"{dp} x tp {tp}, the same eight processes: {ZERO3_STEPS} steps "
          f"and the fp32 check in {outs[0]['zero3_s']:.1f} s")
    if not all(math.isfinite(x) for x in losses + runs[0]["grad_norms"]):
        fail(f"29: non-finite loss or gradient norm {losses}")
    if any(o["losses"] != losses for o in runs):
        fail(f"29: the ranks disagree on the loss "
             f"{[o['losses'] for o in runs]}")
    if not all(all(o["replicas_equal"]) for o in runs):
        fail(f"29: replicas differ {[o['replica_checks'] for o in runs]}")
    base = runs1[0]["losses"][:ZERO3_STEPS]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, base))
    print(f"[train-zero3] losses {losses} against stage 1's {base}: max "
          f"relative gap {gap:.3e} (tol {CHECK_REL}); gradient norms "
          f"{runs[0]['grad_norms']}")
    if gap > CHECK_REL:
        fail(f"29: stage-3 losses {losses} differ from stage 1's {base}")
    n_leaves = len(tree_leaves(init_pipeline_params(
        None, tc.model, spec.layout, "meta")))
    want = {k: ZERO3_STEPS * v * (n if k == "fused_adamw_flat" else dp * tp)
            for k, v in per_step.items()}
    zero3 = {k: sum(o["launches"][k] for o in runs) for k in want}
    print(f"[train-zero3] launches summed {zero3} (the table x dp x tp; "
          f"fused AdamW a leaf slice a rank: {want}; {n_leaves} leaves)")
    if zero3 != want:
        fail(f"29: launches {zero3} != {want}")
    coll = pred["collectives_zero3"]
    for step in range(ZERO3_STEPS):
        got = {a: sum(o["exchange"]["axis_bytes"][step][a] for o in runs)
               for a in ("pp", "data", "model")}
        if got != coll.by_axis:
            fail(f"29: step {step} handed {got} B to collectives, "
                 f"collective_stats(zero_stage=3) counts {coll.by_axis}")
    kb, kc = coll.bytes_by_kind, coll.count_by_kind
    print(f"[train-zero3] bytes handed to collectives a step, over the "
          f"ranks, equal to collective_stats(zero_stage=3): pp "
          f"{coll.by_axis['pp']}, data {coll.by_axis['data']} (gathers "
          f"{int(kb['all-gather-fsdp'])} in {kc['all-gather-fsdp']} calls, "
          f"reduce-scatters {int(kb['reduce-scatter-fsdp'])} in "
          f"{kc['reduce-scatter-fsdp']}, other gradients "
          f"{int(kb['all-reduce-dp'])}, ZeRO-1 all-gather "
          f"{int(kb['all-gather-dp'])}), model {coll.by_axis['model']}; "
          f"stage 1's data {pred['collectives'].by_axis['data']}")
    for o1, o, b in zip(runs1, runs, [r["base"] for r in outs]):
        co = o["coords"]
        b1, b3 = b["train"], b["zero3"]
        print(f"[train-zero3] {smi} | rank {o['rank']} (pp {co['pp']}, dp "
              f"{co['data']}, tp {co['model']}): step "
              f"{warm_median(o['step_s']) * 1e3:.1f} ms (stage 1 "
              f"{statistics.median(o1['step_s'][1:]) * 1e3:.1f}); over "
              f"each run's base (allocated just before it: {_gib(b3)} GiB, "
              f"stage 1 {_gib(b1)}): max_memory_allocated "
              f"{_gib(o['peak_bytes'] - b3)} GiB (stage 1 "
              f"{_gib(o1['peak_bytes'] - b1)}), weights and state "
              f"{_gib(o['static_bytes'] - b3)} (stage 1 "
              f"{_gib(o1['static_bytes'] - b1)}); MemoryModel's model "
              f"state {pred['model_state_zero3'] / 2 ** 30:.3f} GiB "
              f"(dp_shard={dp}) against {pred['model_state'] / 2 ** 30:.3f}"
              f", its stage {co['pp']} "
              f"{pred['stage_bytes_zero3'][co['pp']] / 2 ** 30:.3f} GiB")
    worst = _check_fp32("29", [o["zero3_check"] for o in outs], ref_max,
                        "loss")
    print(f"[train-zero3] fp32 check ({MESH_CHECK}, stage 3): every rank's "
          f"gradient slices within {worst:.3e} relative of the one-process "
          f"executor's (tol {CHECK_REL})")

    # (B) train() on the regrouped mesh
    sp, sdp, stp = SINGLE_MESH_SHAPE
    spred = single_mesh_predictions()
    stc = _single_mesh_config(1)
    per_rank = expected_single_launches(stc.model, spred["m"])
    out = {}
    first = None
    for z, steps in SINGLE_MESH_RUNS:
        runs = [o["single"][z] for o in outs]
        losses = runs[0]["losses"]
        if not all(math.isfinite(x) for x in losses):
            fail(f"29 (train, stage {z}): non-finite loss {losses}")
        if any(o["losses"] != losses for o in runs):
            fail(f"29 (train, stage {z}): the ranks disagree on the loss "
                 f"{[o['losses'] for o in runs]}")
        if first is None:
            first = losses
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, first))
        if losses[0] != first[0]:
            fail(f"29 (train): stage {z}'s first loss {losses[0]} differs "
                 f"from stage {SINGLE_MESH_RUNS[0][0]}'s {first[0]}")
        if not all(all(o["replicas_equal"]) for o in runs):
            fail(f"29 (train, stage {z}): replicas differ "
                 f"{[o['replica_checks'] for o in runs]}")
        coll = spred["collectives"][z]
        for step in range(steps):
            got = {a: sum(o["exchange"]["axis_bytes"][step][a] for o in runs)
                   for a in ("pp", "data", "model")}
            if got != coll.by_axis:
                fail(f"29 (train, stage {z}): step {step} handed {got} B "
                     f"to collectives, train_collective_stats counts "
                     f"{coll.by_axis}")
        want = {k: steps * v * n for k, v in per_rank.items()}
        got_l = {k: sum(o["launches"][k] for o in runs) for k in want}
        if got_l != want or any(not o["launches"][k] for o in runs for k in
                                ("rmsnorm_rows", "flash_attention_fwd")):
            fail(f"29 (train, stage {z}): launches {got_l} != {want}")
        out[f"train_single_mesh_zero{z}"] = got_l
        kb = coll.bytes_by_kind
        print(f"[train-single-mesh] {smi} | train() of "
              f"{stc.model.name} full width bf16 ({stc.model.num_layers} "
              f"layers) on pp {sp} x dp {sdp} x tp {stp} (the same eight "
              f"processes), ZeRO stage {z}, {spred['m']} microbatches of "
              f"one {stc.shape.seq_len}-token sequence a dp rank: losses "
              f"{losses} (relative gap to stage {SINGLE_MESH_RUNS[0][0]}'s "
              f"{gap:.3e}); launches {got_l} (expected_single_launches a "
              f"rank); bytes a step by axis {coll.by_axis} (tp sums "
              f"{int(kb['all-reduce-tp'])}, fsdp gathers "
              f"{int(kb['all-gather-fsdp'])}, reduce-scatters "
              f"{int(kb['reduce-scatter-fsdp'] + kb['reduce-scatter-dp'])},"
              f" ZeRO-1 all-gather {int(kb['all-gather-dp'])})")
        for o, b in zip(runs, [r["base"][z] for r in outs]):
            co = o["coords"]
            print(f"[train-single-mesh] {smi} | stage {z} rank {o['rank']} "
                  f"(dp {co['data']}, tp {co['model']}): step "
                  f"{statistics.median(o['step_s'][-1:]) * 1e3:.1f} ms "
                  f"(steps {[round(x * 1e3, 1) for x in o['step_s']]}); "
                  f"over the run's base ({_gib(b)} GiB): "
                  f"max_memory_allocated {_gib(o['peak_bytes'] - b)} GiB, "
                  f"weights and state {_gib(o['static_bytes'] - b)}; "
                  f"MemoryModel's model state "
                  f"{spred['model_state'][z] / 2 ** 30:.3f} GiB")
        worst = _check_fp32(f"29 (train, stage {z})",
                            [o["single_check"][z] for o in outs], single_max,
                            "lsum")
        print(f"[train-single-mesh] fp32 check (4 layers, "
              f"{SINGLE_MESH_CHECK['seq']} tokens, stage {z}): every rank's "
              f"fp32 gradient slices within {worst:.3e} relative of the "
              f"one-process train() step's (tol {CHECK_REL})")
    print(f"[train-single-mesh] regroup, (stage, steps) {SINGLE_MESH_RUNS} "
          f"and the check in {outs[0]['single_s']:.1f} s")
    out["train_mesh_zero3"] = zero3
    return out


# phase 30: Mamba-2 and MoE on the same eight processes (pp 2 x dp 2 x tp
# 2), then train() of each on them regrouped as SINGLE_MESH_SHAPE
FAMILIES = ("mamba2-2.7b", "qwen2-moe-a2.7b")
# steps of phases 30-31 by arch: two for the cheaper family of each phase
# (a step on updated, re-gathered weights), one for the others in
# processes phases 28-29 warmed (two until phase 32 needed the time: the
# second steps took 3.2, 6.0, 2.7 and 4.0 s on a fast host, measured on
# one H100)
FAMILY_STEPS = {"mamba2-2.7b": 2, "qwen2-moe-a2.7b": 1, "whisper-base": 2,
                "paligemma-3b": 1}
FAMILY_SINGLE_STEPS = 1  # (C): train() at stage 1 on SINGLE_MESH_SHAPE
# phase 31: the encoder-decoder and the VLM on the mesh, in the same eight
# processes after phase 30, with its steps and gates: whisper-base on
# MESH_SHAPE; paligemma-3b, its whole vocabulary, on the eight regrouped
# as pp 2 x dp 1 x tp 4 (each rank two of its eight query heads over its
# one K/V head, replicated over the four tp ranks: ROADMAP A item 3b.4's
# widest case).  At pp 2 x dp 2 x tp 2 each rank would hold half of the
# 257216-row table with its fp32 gradient and state whole over dp
# (family_reckoning: 47.5 GiB of weights, gradients, state and logits for
# the eight, before eight CUDA contexts and the activations: too close to
# one card)
ENCVLM = ("whisper-base", "paligemma-3b")
ENCVLM_SHAPE = {"paligemma-3b": (2, 1, 4)}


class _DroppedRecorder:
    """Every MoE layer's ``router_fraction_dropped`` in the F ops of an
    executor run, by ``(device column, chunk, microbatch)`` in layer
    order: ``moe_ffn`` and the executor's op wrapped while it is
    entered."""

    def __init__(self):
        self.rec, self.cur = {}, None

    def __enter__(self):
        from repro_torch.core import pipeline_runtime as PR
        from repro_torch.core.tasktable import F_OPS
        from repro_torch.models import moe as MOE
        self.op, self.ffn = PR._Executor._op, MOE.moe_ffn
        me = self

        def op(ex, d, row, *a):
            me.cur = (d, int(row[1]), int(row[2])) \
                if int(row[0]) in F_OPS else None
            try:
                return me.op(ex, d, row, *a)
            finally:
                me.cur = None

        def ffn(*a, **k):
            y, aux = me.ffn(*a, **k)
            if me.cur is not None:
                me.rec.setdefault(me.cur, []).append(
                    float(aux["router_fraction_dropped"]))
            return y, aux
        PR._Executor._op, MOE.moe_ffn = op, ffn
        return self

    def __exit__(self, *exc):
        from repro_torch.core import pipeline_runtime as PR
        from repro_torch.models import moe as MOE
        PR._Executor._op, MOE.moe_ffn = self.op, self.ffn


def _families_body(mesh, single, log, free, base, refs, archs=FAMILIES):
    """Phase 30 (31, ``archs`` ``ENCVLM``) on one rank, after phase 29
    (30): for each of ``archs``, its ``FAMILY_STEPS`` steps of
    ``_mesh_config(arch)`` on ``mesh`` regrouped as its ``_mesh_shape``
    (the main path, launches counted) and its fp32 check; then on
    ``single`` (the processes regrouped as ``SINGLE_MESH_SHAPE``)
    ``train()`` of each at stage 1 and its fp32 check.  ``refs``: arch ->
    the one-process references' paths."""
    import torch

    from repro_torch.launch.train import train_rank, train_single_rank
    out, meshes = {}, {tuple(mesh.sizes): mesh}
    for arch in archs:
        shape = tuple(_mesh_shape(arch))
        if shape not in meshes:
            meshes[shape] = mesh.regroup(shape)
        on = meshes[shape]
        t0 = time.perf_counter()
        base[arch] = free()
        r = {"train": train_rank(on, _mesh_config(arch), shape[0],
                                 {"overlap": True,
                                  "steps": FAMILY_STEPS[arch], "log": log})}
        free()
        r["check"] = _mesh_fp32_check(torch, on, refs[arch]["pipe"],
                                      arch=arch)
        free()
        r["s"] = time.perf_counter() - t0
        out[arch] = r
    for arch in archs:
        t0 = time.perf_counter()
        base["single " + arch] = free()
        r = out[arch]
        r["single"] = train_single_rank(
            single, _single_mesh_config(1, arch=arch),
            {"steps": FAMILY_SINGLE_STEPS, "log": log})
        free()
        r["single_check"] = _single_mesh_fp32_check(
            torch, single, refs[arch]["single"], 1, arch)
        free()
        r["single_s"] = time.perf_counter() - t0
    return out


def family_reckoning(tc, zero_stage: int = 1, shape=MESH_SHAPE) -> dict:
    """What a rank of ``shape`` holds of ``tc``'s model, reckoned on the
    host from its ``RankShard`` (no card): per pp coordinate the weights
    (their dtype), the gradient accumulators (the block leaves in their
    dtype, the shared leaves in fp32) and the fp32 optimizer state
    (master, mu and nu of the dp slices), in bytes; the last stage's fp32
    logits ``[mbB * tokens, V / tp]`` once (a VLM's head sees the tokens
    only); and their sum over the ranks."""
    from repro_torch.core.pipeline_runtime import (RankShard,
                                                   init_pipeline_params)
    from repro_torch.launch.mesh import MESH_RULES
    from repro_torch.tree import tree_leaves
    pp, dp, tp = shape
    spec = _spec_of(tc, pp)
    tree = init_pipeline_params(None, tc.model, spec.layout, "meta")
    out = {}
    for p in range(pp):
        sh = RankShard(tc.model, spec.layout, {"pp": pp, "data": dp,
                                               "model": tp}, MESH_RULES,
                       {"pp": p, "data": 0, "model": 0}, zero_stage)
        w = g = st = 0
        for i, (path, a) in enumerate(zip(sh.paths, tree_leaves(tree))):
            n = (a[0].numel() if path[0] == "blocks" else a.numel())
            n //= sh.tp_parts[i]
            w += n * a.element_size()
            g += n * (a.element_size() if path[0] == "blocks" else 4)
            st += 12 * (n // dp if sh.zero_dims[i] is not None else n)
        V = tc.model.vocab_size
        logits = (4 * spec.mbB * (spec.S - spec.prefix)
                  * (V // tp if V % tp == 0 else V) if p == pp - 1 else 0)
        out[p] = {"weights": w, "grads": g, "state": st, "logits": logits,
                  "total": w + g + st + logits}
    out["ranks"] = dp * tp * sum(out[p]["total"] for p in range(pp))
    return out


def families_predictions(archs=FAMILIES) -> dict:
    """Phase 30's (31's) reckoning on the host, per family of ``archs``:
    ``family_reckoning`` on its ``_mesh_shape``, the same at the whole
    vocabulary, ``MemoryModel``'s stage prediction at (pp, tp) as phase
    28's, and the bytes a step hands to collectives on the mesh
    (``collective_stats``) and of (C)'s ``train()``
    (``train_collective_stats``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import (collective_stats,
                                           train_collective_stats)
    out = {}
    for arch in archs:
        tc = _mesh_config(arch)
        shape = _mesh_shape(arch)
        whole = dataclasses.replace(tc, model=dataclasses.replace(
            tc.model, vocab_size=get_config(arch).vocab_size))
        pred = mesh_predictions(tc, shape)
        stc = _single_mesh_config(1, arch=arch)
        _, sdp, stp = SINGLE_MESH_SHAPE
        m = stc.shape.global_batch // sdp
        out[arch] = {"reckoning": family_reckoning(tc, shape=shape),
                     "reckoning_whole_vocab": family_reckoning(
                         whole, shape=shape),
                     "stage_bytes": pred["stage_bytes"],
                     "collectives": collective_stats(
                         _spec_of(tc, shape[0]), shape[1], shape[2],
                         update=True),
                     "single_m": m,
                     "single_collectives": train_collective_stats(
                         stc.model, m=m, mbB=1, seq_len=stc.shape.seq_len,
                         dp=sdp, tp=stp, zero_stage=1)}
    return out


def phase_families_checks(smi: str, outs, ref_max, archs=FAMILIES,
                          phase: str = "30", key: str = "families",
                          label: str = "train-families") -> dict:
    """30 (and 31, the same gates on ``archs`` ``ENCVLM``): what phase
    28's eight processes ran after phase 29 (30).  (A)
    mamba2-2.7b and (B) qwen2-moe-a2.7b (``_mesh_config``) on pp 2 x dp
    2 x tp 2 through ``train_pipeline(mesh=)``: finite losses equal on
    every rank; after every step the dp replicas and the tp-replicated
    leaves (mamba2: ``wB``, ``wC``, ``conv_B``, ``conv_C``, the norms and
    the tied embedding over pp; qwen2-moe: the router and the norms)
    bitwise equal; launches summed over the ranks the table's x dp x tp
    (the split-width RMSNorm pair for the gated norms, the SSD scan,
    flash, fused AdamW a leaf slice a rank); each step's bytes by axis
    ``collective_stats``'; the fp32 check's gradient shards within
    ``CHECK_REL`` of the one-process executor's, and for qwen2-moe every
    F op's dropped fraction at its capacity factor 1.25 equal on every
    rank and to the one-process run's.  (C) ``train()`` of each on the
    processes regrouped as ``SINGLE_MESH_SHAPE`` at stage 1: losses
    equal on every rank, replicas, bytes ``train_collective_stats``',
    launches ``expected_single_launches(tp=2)`` a rank, the fp32 check.
    Prints each rank's step and peak over its run's base beside the
    reckoning and ``MemoryModel``'s stage prediction.  Phase 31: (A)
    whisper-base at full depth on pp 2 x dp 2 x tp 2 (its encoder over
    tp, flash ``causal=False`` on a rank's 4 heads of its 1500 frames;
    the cross-attention's encoder input summed over tp backward; its
    51865-row table and head whole on every tp rank), (B) paligemma-3b at
    4 layers and its whole vocabulary on the processes regrouped as pp 2
    x dp 1 x tp 4 (its one K/V head on all four tp ranks, their copies
    bitwise equal after every step: replica check "kv"), (C) ``train()``
    of each (paligemma at 2 layers).  ``ref_max``: arch -> the
    one-process references' largest |element| a leaf.  Returns the
    launch counts by path (``key``'s).  ``outs[r][key][arch]`` holds what
    rank ``r`` ran of ``arch``; ``label`` tags the printed lines."""
    from repro_torch.core.pipeline_runtime import init_pipeline_params
    from repro_torch.tree import tree_leaves
    preds = families_predictions(archs)
    launches = {}
    for arch in archs:
        pp, dp, tp = _mesh_shape(arch)
        n = pp * dp * tp
        tag = f"{phase} ({arch})"
        tc = _mesh_config(arch)
        spec = _spec_of(tc, pp)
        pred = preds[arch]
        fam = [o[key][arch] for o in outs]
        runs = [f["train"] for f in fam]
        losses = runs[0]["losses"]
        print(f"[{label}] {smi} | {arch} full width bf16 "
              f"({tc.model.num_layers} layers, vocab "
              f"{tc.model.vocab_size}) on pp {pp} x dp {dp} x tp {tp}, "
              f"the same eight processes: {spec.table.name} "
              f"v={tc.plan.num_chunks} m={spec.table.m}, {spec.mbB} "
              f"sequence a dp rank a microbatch of {spec.S} positions; "
              f"{FAMILY_STEPS[arch]} steps and the fp32 check in "
              f"{fam[0]['s']:.1f} s")
        if not all(math.isfinite(x) for x in losses + runs[0]["grad_norms"]):
            fail(f"{tag}: non-finite loss or gradient norm {losses}")
        if any(o["losses"] != losses for o in runs):
            fail(f"{tag}: the ranks disagree on the loss "
                 f"{[o['losses'] for o in runs]}")
        if not all(all(o["replicas_equal"]) for o in runs):
            fail(f"{tag}: replicas differ "
                 f"{[o['replica_checks'] for o in runs]}")
        n_leaves = len(tree_leaves(init_pipeline_params(
            None, tc.model, spec.layout, "meta")))
        per_step = expected_train_launches(spec, n_leaves, tp=tp)
        want = {k: FAMILY_STEPS[arch] * v * (
                    n if k == "fused_adamw_flat" else dp * tp)
                for k, v in per_step.items()}
        summed = {k: sum(o["launches"][k] for o in runs) for k in want}
        print(f"[{label}] {arch}: losses {losses}, gradient norms "
              f"{runs[0]['grad_norms']}; after every step the dp replicas, "
              f"the tp-replicated leaves and the shared leaves over pp "
              f"bitwise equal on every rank; launches summed {summed} (the "
              f"table x dp x tp; fused AdamW a leaf slice a rank: {want})")
        if summed != want:
            fail(f"{tag}: launches {summed} != {want}")
        used = [k for k, v in want.items() if v]
        if any(not o["launches"][k] for o in runs for k in used):
            fail(f"{tag}: a rank launched no kernel of the path")
        coll = pred["collectives"]
        for step in range(FAMILY_STEPS[arch]):
            got = {a: sum(o["exchange"]["axis_bytes"][step][a] for o in runs)
                   for a in ("pp", "data", "model")}
            if got != coll.by_axis:
                fail(f"{tag}: step {step} handed {got} B to collectives, "
                     f"collective_stats counts {coll.by_axis}")
        kb, kc = coll.bytes_by_kind, coll.count_by_kind
        print(f"[{label}] {arch}: bytes a step over the ranks equal "
              f"to collective_stats' count: pp {coll.by_axis['pp']}, data "
              f"{coll.by_axis['data']} (routing {int(kb.get('all-gather-route', 0))}"
              f" in {kc.get('all-gather-route', 0)} calls), model "
              f"{coll.by_axis['model']} ({kc['all-reduce-tp']} tp sums)")
        rk = pred["reckoning"]
        for o, b in zip(runs, [r["base"][arch] for r in outs]):
            co = o["coords"]
            print(f"[{label}] {smi} | {arch} rank {o['rank']} (pp "
                  f"{co['pp']}, dp {co['data']}, tp {co['model']}): "
                  f"{median_word(o['step_s'])} "
                  f"{warm_median(o['step_s']) * 1e3:.1f} ms "
                  f"(steps {[round(x * 1e3, 1) for x in o['step_s']]}); "
                  f"over the run's base ({_gib(b)} GiB): "
                  f"max_memory_allocated {_gib(o['peak_bytes'] - b)} GiB, "
                  f"weights and state {_gib(o['static_bytes'] - b)}; "
                  f"reckoned {_gib(rk[co['pp']]['total'])} GiB (weights "
                  f"{_gib(rk[co['pp']]['weights'])}, gradients "
                  f"{_gib(rk[co['pp']]['grads'])}, state "
                  f"{_gib(rk[co['pp']]['state'])}, logits "
                  f"{_gib(rk[co['pp']]['logits'])}); MemoryModel's stage "
                  f"{co['pp']} at (pp {pp}, tp {tp}) "
                  f"{pred['stage_bytes'][co['pp']] / 2 ** 30:.3f} GiB")
        print(f"[{label}] {arch}: the eight ranks' reckoning "
              f"{_gib(rk['ranks'])} GiB; at the whole vocabulary "
              f"{_gib(pred['reckoning_whole_vocab']['ranks'])} GiB")
        worst = _check_fp32(tag, [f["check"] for f in fam],
                            ref_max[arch]["pipe"], "loss")
        print(f"[{label}] {arch} fp32 check ({MESH_CHECK}, "
              f"{_mesh_model(arch, True).num_layers} layers, vocab "
              f"{_mesh_model(arch, True).vocab_size}): every rank's "
              f"gradient shard within {worst:.3e} relative of the "
              f"one-process executor's (tol {CHECK_REL}); loss "
              f"{fam[0]['check']['loss']} against "
              f"{fam[0]['check']['parent_loss']}")
        if tc.model.moe is not None:
            for f in fam:
                c = f["check"]
                if not c["dropped"] or c["dropped"] != c["parent_dropped"]:
                    fail(f"{tag}: dropped fractions {c['dropped']} differ "
                         f"from the one-process run's "
                         f"{c['parent_dropped']}")
            per_pp = {o["train"]["coords"]["pp"]: f["check"]["dropped"]
                      for o, f in zip(outs, fam)}
            print(f"[{label}] {arch} fp32 check, capacity factor "
                  f"{tc.model.moe.capacity_factor}: every F op's "
                  f"router_fraction_dropped over the global microbatch "
                  f"equal on every rank and to the one-process run's: "
                  + "; ".join(f"pp {p}: " + ", ".join(
                      f"(chunk {k[1]}, microbatch {k[2]}) {v}"
                      for k, v in per_pp[p]) for p in sorted(per_pp)))
        launches[f"train_{key}_{arch}"] = summed

        # (C) train() on the regrouped processes
        sp, sdp, stp = SINGLE_MESH_SHAPE
        stc = _single_mesh_config(1, arch=arch)
        runs = [f["single"] for f in fam]
        losses = runs[0]["losses"]
        if not all(math.isfinite(x) for x in losses):
            fail(f"{tag} (train): non-finite loss {losses}")
        if any(o["losses"] != losses for o in runs):
            fail(f"{tag} (train): the ranks disagree on the loss "
                 f"{[o['losses'] for o in runs]}")
        if not all(all(o["replicas_equal"]) for o in runs):
            fail(f"{tag} (train): replicas differ "
                 f"{[o['replica_checks'] for o in runs]}")
        coll = pred["single_collectives"]
        for step in range(FAMILY_SINGLE_STEPS):
            got = {a: sum(o["exchange"]["axis_bytes"][step][a] for o in runs)
                   for a in ("pp", "data", "model")}
            if got != coll.by_axis:
                fail(f"{tag} (train): step {step} handed {got} B to "
                     f"collectives, train_collective_stats counts "
                     f"{coll.by_axis}")
        per_rank = expected_single_launches(stc.model, pred["single_m"],
                                            tp=stp)
        want = {k: FAMILY_SINGLE_STEPS * v * n for k, v in per_rank.items()}
        got_l = {k: sum(o["launches"][k] for o in runs) for k in want}
        if got_l != want:
            fail(f"{tag} (train): launches {got_l} != {want}")
        launches[f"train_single_{key}_{arch}"] = got_l
        print(f"[{label}] {smi} | train() of {arch} full width "
              f"bf16 ({stc.model.num_layers} layers, vocab "
              f"{stc.model.vocab_size}) on pp {sp} x dp {sdp} x tp {stp}, "
              f"stage 1, {pred['single_m']} microbatches of one "
              f"{stc.shape.seq_len}-token sequence a dp rank: losses "
              f"{losses}; launches {got_l} (expected_single_launches a "
              f"rank); bytes a step by axis {coll.by_axis}; in "
              f"{fam[0]['single_s']:.1f} s")
        for o, b in zip(runs, [r["base"]["single " + arch] for r in outs]):
            co = o["coords"]
            print(f"[{label}] {smi} | train() {arch} rank "
                  f"{o['rank']} (dp {co['data']}, tp {co['model']}): step "
                  f"{o['step_s'][-1] * 1e3:.1f} ms; over the run's base "
                  f"({_gib(b)} GiB): max_memory_allocated "
                  f"{_gib(o['peak_bytes'] - b)} GiB, weights and state "
                  f"{_gib(o['static_bytes'] - b)}")
        worst = _check_fp32(f"{tag} (train)",
                            [f["single_check"] for f in fam],
                            ref_max[arch]["single"],
                            "lsum")
        print(f"[{label}] train() {arch} fp32 check "
              f"({_mesh_model(arch, True, True).num_layers} layers, "
              f"{SINGLE_MESH_CHECK['seq']} tokens, stage 1): every rank's "
              f"fp32 gradient slices within {worst:.3e} relative of the "
              f"one-process train() step's (tol {CHECK_REL})")
    return launches


# ---------------------------------------------------------------------------
# phase 32: Chronos-Offload and checkpoints on the mesh
# ---------------------------------------------------------------------------

OFFLOAD_MESH_STEPS = MESH_STEPS      # (A): the first a warm-up
# (B): the checkpoint of a one-step run, then a run restored from it to
# step OFFLOAD_MESH_STEPS (no periodic save: the step-0 snapshot and each
# run's final save)
CKPT_MESH_CUT = 1


def _offload_mesh_config():
    """Phase 32's configuration: phase 28's (``_mesh_config()``) with the
    deepest of its two chunks offloaded
    (``OffloadConfig(enabled=True, num_offload_chunks=1)``)."""
    import dataclasses

    from repro_torch.configs.base import OffloadConfig
    tc = _mesh_config()
    return dataclasses.replace(tc, plan=dataclasses.replace(
        tc.plan, offload=OffloadConfig(enabled=True, num_offload_chunks=1)))


def _offload_fp32_check(torch, mesh, ref_path):
    """On one rank: one step of phase 28's fp32 check configuration with
    the deepest chunk offloaded, through ``make_pipeline_train_step``:
    the rank's shipment (its parts of the deep gradient sums) against
    the same parts of phase 28's one-process reference (``ref_path``):
    each leaf's max |difference|, and the largest |element| of each
    global deep leaf of the reference, for the relative bound."""
    from repro_torch.configs.base import (OffloadConfig, OptimizerConfig,
                                          ParallelPlan, ShapeConfig)
    from repro_torch.core.pipeline_runtime import rank_params
    from repro_torch.launch.steps import (make_pipeline_train_step,
                                          offload_kept)
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves
    c, dev, p = MESH_CHECK, mesh.device, mesh.coord("pp")
    plan = ParallelPlan(schedule="chronos_zb",
                        num_chunks=MESH_CHUNKS["tinyllama-1.1b"],
                        microbatch_size=1, num_microbatches=c["m"],
                        kernels="fused",
                        offload=OffloadConfig(enabled=True,
                                              num_offload_chunks=1))
    step, m, _, spec = make_pipeline_train_step(
        _mesh_model("tinyllama-1.1b", True),
        ShapeConfig("check", c["seq"], c["m"] * mesh.dp, "train"), plan,
        OptimizerConfig(), P=mesh.pp, device=dev, mesh=mesh, overlap=True)
    params, batch = _mesh_check_inputs(torch, spec, dev, mesh.dp)
    params = rank_params(params, p, step.shard)
    gc.collect()
    torch.cuda.empty_cache()       # the whole tree each rank drew
    kept, _ = offload_kept(params, plan, column=True)
    out = step(params, adamw_init(step.kept_shard.zero_views(kept)), batch)
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    _, want = offload_kept(step.shard.cut(ref["g"], p), plan, column=True)
    _, whole = offload_kept(ref["g"], plan)
    got = tree_leaves(out.shipment)
    diff = [float((a - step.deep_shard.zero_slice(b, i).to(dev))
                  .abs().max())
            for i, (a, b) in enumerate(zip(got, tree_leaves(want),
                                           strict=True))]
    return {"diff": diff, "top": [float(a.abs().max())
                                  for a in tree_leaves(whole)],
            "paths": ["/".join(map(str, q))
                      for q in step.deep_shard.paths],
            "loss": float(out.metrics["loss"]),
            "parent_loss": float(ref["loss"]), "m": m}


def _offload_mesh_body(mesh, ref_path, ckdir, log, free, base):
    """Phase 32 on one rank, after phase 31 in the same processes.  (A)
    ``_offload_mesh_config()``'s ``OFFLOAD_MESH_STEPS`` steps on the
    mesh (the main path, launches counted), each collect's deep parts
    held against the rank's host masters rounded to bf16 after the run
    (the collect only copies both; ``record_s``: the copies' host time,
    a collect's), the shipment's fp32 check.  (B) ``CKPT_MESH_CUT`` step into ``ckdir`` (the step-0
    snapshot and the final save), then a run restored from it to step
    ``OFFLOAD_MESH_STEPS``, each restored leaf's digest taken right after
    the restore against the digests of what the first run saved; rank 0
    returns the checkpoint's manifest.  The page-locked host cache is
    released before (A) and between (A) and (B)."""
    import dataclasses
    import json as _json

    import torch

    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.launch.train import (leaf_digest, train_pipeline,
                                          train_rank)
    from repro_torch.optim import offload as offload_mod
    from repro_torch.tree import tree_leaves
    tc = _offload_mesh_config()
    res = {}
    t0 = time.perf_counter()
    base["offload"] = free()            # releases the host cache too
    recorded, record_s = [], []
    collect = offload_mod.ChronosOffloadRunner.collect

    def recorded_collect(self):
        # inside the step's timed window: only copies are taken here (the
        # deep parts on the card, the host masters), compared after the
        # run; their host time is returned beside the step times
        out = collect(self)
        t_r = time.perf_counter()
        recorded.append(([w.clone() for w in tree_leaves(self.deep)],
                         [m.copy() for m in tree_leaves(self.opt.master)]))
        record_s.append(time.perf_counter() - t_r)
        return out
    offload_mod.ChronosOffloadRunner.collect = recorded_collect
    try:
        res["train"] = train_rank(mesh, tc, mesh.pp, {
            "overlap": True, "steps": OFFLOAD_MESH_STEPS, "log": log})
    finally:
        offload_mod.ChronosOffloadRunner.collect = collect
    res["deep_ok"] = [all(
        torch.equal(w, torch.from_numpy(mst).to(w.device)
                    .to(torch.bfloat16).to(w.dtype))
        for w, mst in zip(dev, host)) for dev, host in recorded]
    res["record_s"] = record_s
    del recorded
    free()
    res["check"] = _offload_fp32_check(torch, mesh, ref_path)
    res["a_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    base["ckpt"] = free()
    tck = dataclasses.replace(tc, checkpoint_dir=ckdir,
                              checkpoint_every=10 ** 6)

    def digests(params, opt_state):
        return [leaf_digest(a).tolist() for _, a in
                ckpt._flatten({"params": params, "opt": opt_state})]
    first = train_pipeline(tck, P=mesh.pp, mesh=mesh, overlap=True,
                           steps=CKPT_MESH_CUT, log=log)
    saved = digests(first["params"], first["opt_state"])
    res["ckpt_first"] = {k: first[k] for k in ("losses",
                                               "checkpoint_records")}
    del first
    free()
    restored = []
    restore = ckpt.MeshCheckpointer.restore_into

    def digested_restore(self, tree, step=None, parts=None):
        extra = restore(self, tree, step, parts)
        restored.append(digests(tree["params"], tree["opt"]))
        return extra
    ckpt.MeshCheckpointer.restore_into = digested_restore
    try:
        second = train_pipeline(tck, P=mesh.pp, mesh=mesh, overlap=True,
                                steps=OFFLOAD_MESH_STEPS, log=log)
    finally:
        ckpt.MeshCheckpointer.restore_into = restore
    res["ckpt_second"] = {k: second[k] for k in (
        "losses", "start_step", "checkpoint_records")}
    res["restored_equal"] = len(restored) == 1 and restored[0] == saved
    res["n_digests"] = len(saved)
    del second
    if mesh.rank == 0:
        with open(os.path.join(ckdir, f"step_{CKPT_MESH_CUT:08d}",
                               "manifest.json")) as f:
            res["manifest"] = _json.load(f)
    free()
    res["b_s"] = time.perf_counter() - t0
    return res


def one_device_manifest(tc, P: int):
    """The leaves of the checkpoint the one-device ``train_pipeline`` of
    ``tc`` writes (``path``, ``file``, ``shape``, ``dtype``, ``spec``),
    reckoned on the meta device: its stage-stacked parameters and the
    optimizer state of what the device updates (under offload the kept
    part: ``offload_kept``)."""
    from repro_torch.core.pipeline_runtime import init_pipeline_params
    from repro_torch.ft.checkpoint import _flatten
    from repro_torch.launch.steps import offload_kept
    from repro_torch.optim import adamw_init
    spec = _spec_of(tc, P)
    meta = init_pipeline_params(None, tc.model, spec.layout, "meta")
    kept = offload_kept(meta, tc.plan)[0] if tc.plan.offload.enabled \
        else meta
    pairs = _flatten({"params": meta, "opt": adamw_init(kept)})
    return [{"path": p, "file": f"leaf_{i}.bin", "shape": list(a.shape),
             "dtype": str(a.dtype).removeprefix("torch."), "spec": None}
            for i, (p, a) in enumerate(pairs)]


def phase_offload_mesh_checks(smi: str, outs, runs28, bases) -> dict:
    """32: what phase 28's eight processes ran after phase 31.  (A)
    ``_offload_mesh_config()`` on pp 2 x dp 2 x tp 2: finite losses equal
    on every rank, the step-1 losses bitwise phase 28's (``runs28``);
    after every step the dp replicas and the tp-replicated leaves
    bitwise equal; each collect's deep parts on the card equal to the
    rank's host masters rounded to bf16; launches summed over the ranks
    the table's x dp x tp for RMSNorm and flash and one fused-AdamW
    launch a kept leaf slice a rank a step (none for the deep slices,
    whose AdamW is the host's); each step's bytes by axis
    ``collective_stats(offload_chunks=1)``'s (the kept leaves' ZeRO-1
    gather and the deep leaves' after the upload); the fp32 check's
    shipment within ``CHECK_REL`` of the one-process deep gradients.
    Prints each rank's step, peak and weights and state beside phase
    28's (each over its run's base), ``collect_wait_s``, the host update
    seconds and the copies' GB/s, and the Eq. (5)/(7) report at tp 2.
    (B) the one-step run's checkpoint and the run restored from it: the
    first run's loss bitwise (A)'s step 1, the restored run's start step
    ``CKPT_MESH_CUT`` and its loss bitwise (A)'s step 2, every restored
    leaf's digest equal to what was saved, the manifest's leaves those
    the one-device port writes for the same plan; prints each rank's
    save and restore GB/s.  Returns (A)'s launch counts."""
    from repro_torch.core.pipeline_runtime import init_pipeline_params
    from repro_torch.launch.dryrun import collective_stats
    from repro_torch.tree import tree_leaves
    pp, dp, tp = MESH_SHAPE
    n = pp * dp * tp
    tc = _offload_mesh_config()
    spec = _spec_of(tc, pp)
    steps = OFFLOAD_MESH_STEPS
    res = [o["offload"] for o in outs]
    runs = [r["train"] for r in res]
    losses = runs[0]["losses"]
    print(f"[train-mesh-offload] {smi} | phase 28's {tc.model.name} "
          f"({tc.model.num_layers} layers) with {tc.plan.offload} on pp "
          f"{pp} x dp {dp} x tp {tp}, the same eight processes: "
          f"{steps} steps and the fp32 check in {res[0]['a_s']:.1f} s; "
          f"the checkpoint run and the restored run in "
          f"{res[0]['b_s']:.1f} s")
    if not all(math.isfinite(x) for x in losses + runs[0]["grad_norms"]):
        fail(f"32: non-finite loss or gradient norm {losses}")
    if any(o["losses"] != losses for o in runs):
        fail(f"32: the ranks disagree on the loss "
             f"{[o['losses'] for o in runs]}")
    if losses[0] != runs28[0]["losses"][0]:
        fail(f"32: step-1 loss {losses[0]} != phase 28's "
             f"{runs28[0]['losses'][0]}")
    if not all(all(o["replicas_equal"]) for o in runs):
        fail(f"32: replicas differ {[o['replica_checks'] for o in runs]}")
    if not all(len(r["deep_ok"]) == steps and all(r["deep_ok"])
               for r in res):
        fail(f"32: deep parts differ from the host masters through bf16 "
             f"{[r['deep_ok'] for r in res]}")
    rec = [t for r in res for t in r["record_s"]]
    print(f"[train-mesh-offload] losses {losses} (phase 28 "
          f"{runs28[0]['losses']}: step 1 bitwise); gradient norms "
          f"{runs[0]['grad_norms']} (the shallow and shared leaves'); "
          f"replicas equal after every step; every collect's deep parts "
          f"the rank's host masters through bf16 ({steps} a rank, "
          f"compared after the run; their copies took {min(rec):.4f}-"
          f"{max(rec):.4f} s a collect, inside collect_wait_s and the "
          f"step times below)")
    n_leaves = len(tree_leaves(init_pipeline_params(
        None, tc.model, spec.layout, "meta")))
    per_step = expected_train_launches(spec, n_leaves)
    want = {k: steps * v * (n if k == "fused_adamw_flat" else dp * tp)
            for k, v in per_step.items()}
    summed = {k: sum(o["launches"][k] for o in runs) for k in want}
    print(f"[train-mesh-offload] launches summed {summed} (the table x dp "
          f"x tp; fused AdamW a kept leaf slice a rank a step: {want})")
    if summed != want or any(not o["launches"][k] for o in runs for k in (
            "rmsnorm_rows", "flash_attention_fwd", "fused_adamw_flat")):
        fail(f"32: launches {summed} != {want}")
    coll = collective_stats(spec, dp, tp, update=True, offload_chunks=1)
    for step in range(steps):
        got = {a: sum(o["exchange"]["axis_bytes"][step][a] for o in runs)
               for a in ("pp", "data", "model")}
        if got != coll.by_axis:
            fail(f"32: step {step} handed {got} B to collectives, "
                 f"collective_stats(offload_chunks=1) counts "
                 f"{coll.by_axis}")
    kb = coll.bytes_by_kind
    data28 = collective_stats(_spec_of(_mesh_config(), pp), dp, tp,
                              update=True).by_axis["data"]
    print(f"[train-mesh-offload] bytes handed to collectives a step, over "
          f"the ranks, equal to collective_stats(offload_chunks=1): "
          f"{coll.by_axis} (kept ZeRO-1 all-gather "
          f"{int(kb['all-gather-dp'])}, deep all-gather after the upload "
          f"{int(kb['all-gather-deep'])}; phase 28's data {data28})")
    for r, o, o28, b in zip(res, runs, runs28, bases):
        co, rep = o["coords"], o["offload"]
        b28, b32 = b["train"], b["offload"]
        print(f"[train-mesh-offload] {smi} | rank {o['rank']} (pp "
              f"{co['pp']}, dp {co['data']}, tp {co['model']}): step "
              f"{warm_median(o['step_s']) * 1e3:.1f} ms (steps "
              f"{[round(x * 1e3, 1) for x in o['step_s']]}; phase 28 "
              f"{warm_median(o28['step_s']) * 1e3:.1f}); over each run's "
              f"base: max_memory_allocated {_gib(o['peak_bytes'] - b32)} "
              f"GiB (phase 28 {_gib(o28['peak_bytes'] - b28)}), weights "
              f"and state {_gib(o['static_bytes'] - b32)} (phase 28 "
              f"{_gib(o28['static_bytes'] - b28)}); collect_wait_s "
              f"{rep['collect_wait_s']:.3f}, overlapped "
              f"{rep['overlapped']}/{rep['submits']}, host update s "
              f"{[round(t, 3) for t in rep['host_update_s']]}, copy-down "
              f"{rep['bytes_down'] / 1e6:.1f} MB at GB/s "
              f"{[round(g, 2) for g in rep['copy_down_gbps']]}, upload "
              f"{rep['bytes_up'] / 1e6:.1f} MB at GB/s "
              f"{[round(g, 2) for g in rep['upload_gbps']]}")
    rep = runs[0]["offload"]
    print(f"[train-mesh-offload] Eq. (5)/(7) model at tp {tp}, the global "
          f"microbatch {spec.mbB * dp}, pcie_gbps="
          f"{tc.plan.offload.pcie_gbps}, cpu_flops="
          f"{tc.plan.offload.cpu_flops} (its inputs, not measured): "
          f"eq5_offload_ok {rep['eq5_offload_ok']}, eq7_upload_ok "
          f"{rep['eq7_upload_ok']}, predicted_overlap_ratio "
          f"{rep['predicted_overlap_ratio']:.4f}; measured_overlap_frac "
          f"{rep['measured_overlap_frac']:.4f}")
    worst = 0.0
    for r in res:
        c = r["check"]
        rel = [d / max(t, 1e-30) for d, t in zip(c["diff"], c["top"])]
        worst = max(worst, max(rel))
        if max(rel) > CHECK_REL or abs(c["loss"] - c["parent_loss"]) > \
                CHECK_REL * abs(c["parent_loss"]):
            fail(f"32: the rank's fp32 shipment differs from the "
                 f"one-process deep gradients: max rel {max(rel):.3e} at "
                 f"{c['paths'][rel.index(max(rel))]}, loss {c['loss']} vs "
                 f"{c['parent_loss']}")
    print(f"[train-mesh-offload] fp32 check ({MESH_CHECK}): every rank's "
          f"shipment (its ZeRO slices of the deep gradient sums) within "
          f"{worst:.3e} relative of phase 28's one-process deep gradients "
          f"(tol {CHECK_REL})")

    # (B) the checkpoint written by the ranks, and the run restored from it
    first = [r["ckpt_first"] for r in res]
    second = [r["ckpt_second"] for r in res]
    if any(f["losses"] != losses[:CKPT_MESH_CUT] for f in first):
        fail(f"32 (B): the checkpoint run's losses "
             f"{[f['losses'] for f in first]} != (A)'s")
    if any(s["start_step"] != CKPT_MESH_CUT or
           s["losses"] != losses[CKPT_MESH_CUT:] for s in second):
        got = [(s["start_step"], s["losses"]) for s in second]
        fail(f"32 (B): the restored runs' (start, losses) {got} != (A)'s "
             f"steps after {CKPT_MESH_CUT}: {losses[CKPT_MESH_CUT:]}")
    if not all(r["restored_equal"] for r in res):
        fail("32 (B): restored leaves differ from what was saved")
    manifest = res[0]["manifest"]
    expect = one_device_manifest(tc, pp)
    if manifest["leaves"] != expect or manifest["paths"] != [
            m["path"] for m in expect]:
        fail("32 (B): the manifest's leaves differ from the one-device "
             "port's for the same plan")
    print(f"[train-mesh-offload] (B) checkpoint after step "
          f"{CKPT_MESH_CUT} restored into a new run: step "
          f"{CKPT_MESH_CUT + 1} loss {second[0]['losses']} bitwise (A)'s; "
          f"{res[0]['n_digests']} leaves a rank restored bitwise what was "
          f"saved (digests); the manifest's {len(expect)} leaves (paths, "
          f"global shapes, dtypes) the one-device port's")
    for r in res:
        co = r["train"]["coords"]
        print(f"[train-mesh-offload] {smi} | rank {r['train']['rank']} (pp "
              f"{co['pp']}, dp {co['data']}, tp {co['model']}): its parts "
              f"of the checkpoints (a sync save waits for rank 0 to "
              f"publish):")
        print_checkpoint_records(
            f"train-mesh-offload rank {r['train']['rank']}",
            r["ckpt_first"]["checkpoint_records"]
            + r["ckpt_second"]["checkpoint_records"])
    return {"train_mesh_offload": summed}


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
    smi = smi.splitlines()[0]
    print(smi)
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
    phase_flash_tp(torch, gen, by_name)
    phase_flash_d256(torch, gen, by_name)
    phase_flash_encvlm(torch, gen, by_name)
    phase_rmsnorm_widths(torch, gen)
    phase_flash_offsets(torch, gen, by_name)
    phase_flash_offsets(torch, gen, by_name, H=32, G=32, d=128, n_seqs=(4,),
                        key="train_planner_deepseek")
    phase_deepseek_rmsnorm(torch, gen, by_name)
    phase_ssd_grads(torch, gen)
    phase_ssd_h0(torch, gen, by_name)
    phase_mamba_shapes(torch, gen, by_name)
    rows += phase_rmsnorm_split(torch, gen, by_name)
    torch.cuda.empty_cache()
    done("kernels against their plain versions")

    # 4. serve at full width through the CLI's main(), then a profiled
    #    second run on the same engine
    launches = {}
    launches["serve_tinyllama"], eng, _ = phase_serve(torch)
    phase_profile(torch, eng)
    count_decode_tick(torch, eng)
    del eng
    done("serve")

    # 5. serve checks
    phase_checks(torch)
    torch.cuda.empty_cache()
    done("serve checks")

    # 5a-5b. serve mamba2-2.7b (every prefill scan on the SSD kernel from
    #     the slot's carried state) and qwen2-moe-a2.7b at full width,
    #     each with phase 4's gates and phase 5's checks
    phase_serve_family(torch, serve_argv("mamba2-2.7b", 128, 2, 256),
                       "serve-mamba2", launches, "serve_mamba2")
    done("serve mamba2-2.7b")
    phase_serve_family(torch, serve_argv("qwen2-moe-a2.7b"),
                       "serve-qwen2-moe", launches, "serve_qwen2_moe")
    done("serve qwen2-moe-a2.7b")

    # 6. train tinyllama at full width through train_pipeline, then a
    #    profiled step; 7. its train checks.  Phase 26's dry run on the
    #    meta device starts beside it, in a child process
    dry = DryRun()
    bwd_ms = {
        "attn": by_name["flash_attention_fwd"]["train"]["plain_bwd_ms"],
        "mamba": by_name["ssd_scan"]["plain_bwd_ms"],
        **{("attn", Sc): ms for Sc, ms in by_name["flash_attention_fwd"][
            "train_offsets_plain_bwd_ms"].items()}}
    base = {"tinyllama-1.1b": phase_train(torch, "tinyllama-1.1b", "train",
                                          bwd_ms, count=True)}
    launches["train_tinyllama"] = base["tinyllama-1.1b"]["launches"]
    done("train tinyllama-1.1b")
    phase_train_checks(torch, "tinyllama-1.1b", "train-check")
    done("train checks tinyllama-1.1b")

    # 8. train mamba2 at full width, 8 layers (all of tinyllama's
    #    tensors freed first), then a profiled step; 9. its train checks
    gc.collect()
    torch.cuda.empty_cache()
    base["mamba2-2.7b"] = phase_train(torch, "mamba2-2.7b", "train-mamba2",
                                      bwd_ms, layers=MAMBA2_TRAIN_LAYERS,
                                      count=True)
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
        count=True, inspect=lambda tc, spec, out: moe_router_stats(
            torch, tc, spec, out))["launches"]
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

    # 23. resilient serving at full width: tinyllama-1.1b P=3 -> 2 -> 1
    #     through a corruption, a straggler, a lost stage and a hung tick,
    #     every stream the P=1 oracle's; the CLI's overload path (bursty
    #     arrivals, deadlines, a queue bound); 24. single-host batched
    #     serving (--pipelined 0)
    launches.update(phase_serve_resilient(torch))
    done("serve-resilient")
    launches["serve_batched"] = phase_serve_batched(torch)
    done("serve-batched")

    # 25. the compressed wire at full width: 25a bf16 (bitwise phase 6),
    #     25b int8 with the int8 shared-gradient sum, 25c phase 11's offload
    #     with the int8 shipment; 25d their fp32 checks, card against CPU
    gc.collect()
    torch.cuda.empty_cache()
    wire_launches = phase_train_wire(torch, base)
    launches.update(wire_launches)
    phase_wire_checks(torch)
    done("train-wire checks (25d)")

    # 26. the roofline: the steps counted on the card in phases 6, 8, 10
    #     and 15a against the dry run on the meta device (FLOPs and kernel
    #     sums equal), with mfu, useful_ratio and the dominant term
    gc.collect()
    torch.cuda.empty_cache()
    phase_roofline(torch, smi, dry)
    done("roofline")

    # 27. phase 6's configuration at 8 layers as four processes on the
    #     card, one pipeline stage each (gloo through page-locked host memory), the
    #     overlapped and the synchronous exchange, and the fp32 check
    gc.collect()
    torch.cuda.empty_cache()
    launches["train_ranks"] = phase_train_ranks(torch, smi)
    done("train-ranks")

    # 28. data and tensor parallelism beside the pipe axis: four layers
    #     of tinyllama-1.1b at full width on a pp 2 x dp 2 x tp 2 mesh of
    #     eight processes on the card, and its fp32 check; 29. in the same
    #     processes, the same at ZeRO stage 3, then train() on them
    #     regrouped as pp 1 x dp 4 x tp 2 at stages 1 and 3
    #     30. in the same processes, mamba2-2.7b and qwen2-moe-a2.7b on
    #     the pp 2 x dp 2 x tp 2 mesh (the Mamba-2 gated norm on the
    #     split-width RMSNorm pair, the experts split over tp, the MoE
    #     routing over the global microbatch), then train() of each on
    #     the processes regrouped as pp 1 x dp 4 x tp 2
    #     31. in the same processes, whisper-base on pp 2 x dp 2 x tp 2 and
    #     paligemma-3b on pp 2 x dp 1 x tp 4 (its one K/V head replicated
    #     over the four tp ranks), then train() of each on pp 1 x dp 4 x
    #     tp 2
    #     32. in the same processes, phase 28's model with Chronos-Offload
    #     on pp 2 x dp 2 x tp 2 (each rank's deep slices updated on the
    #     host), then a checkpoint written by the ranks and a run restored
    #     from it
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_train_mesh(torch, smi))
    done("train-mesh, train-zero3, train-families, train-encvlm and "
         "train-mesh-offload (28-32)")

    # 33. kernels line, then the result line.  ``launches`` sums the
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
