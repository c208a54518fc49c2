"""One-card dry run: every (architecture x input shape) cell built on the
meta device, its memory and its roofline recorded (counterpart of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch tinyllama-1.1b --shape train_4k --P 4
    PYTHONPATH=src python -m repro_torch.roofline.summarize

The reference lowers each cell on a 256- or 512-chip mesh and reads the
partitioned HLO.  Here a cell is one card's: a training shape runs the
port's pipeline step over ``--P`` virtual stages with the reference's
``default_plan`` (``chronos``, v=2, Chronos-Recomp of the shallowest
chunk, 2 sequences a microbatch), or with ``--plan-hbm-gb`` the pick of
:func:`repro_torch.plan.plan_under_budget` for a stage budget of that
many GB; a serving shape runs the LM's prefill chunks over the prompt
(2048 tokens each, the engine's unit of work) or one decode step
over a full cache, for the shape's whole batch.  Parameters, optimizer
state, caches and batches are meta tensors: shapes without storage, so
grok-1-314b builds in seconds and nothing runs on a device.

The work is counted by :func:`repro_torch.roofline.count_work`, but not
by running the whole step: the training step's executor is built with
:func:`memoized`, which runs each distinct op of the task table once
(by the executor's ``op_key``: device column, chunk, op kind, send and
sequence chunk, and which of its ring slots it uses) and adds that
count again for every later op of the same key; the sends that land in
the rings likewise.  These are ``analyze_hlo``'s loop multipliers: the
count equals a full run's (held against the CPU and a full meta step in
``tests/test_torch_roofline.py`` for the default plan, chronos_zb, the
sequence-chunked schedules and offload, and against the card in
``chip_smoke.py``), and ``train_4k``'s 256 sequences cost as much as a
few.  The single-device ``train()`` step is counted whole up to two
microbatches; past that, at one and two, the difference extended to
all of them.

Each cell writes ``<arch>__<shape>__<tag>.json`` into :data:`RESULTS`
(``DRYRUN_RESULTS``, else ``results/dryrun_torch`` at the checkout's
root, git-ignored): status, plan, the static bytes the port holds
(parameters, gradients and optimizer state per virtual stage, or
weights and cache), the planner's prediction and whether the cell fits
80 GB, the counted work, ``model_flops_for``, the roofline on the H100's
peaks (a reckoning, not a measurement) and the seconds it took.  The
reference's multi-pod layout (a TP=16 mesh, FSDP, the ``pod`` pipeline
axis) per rank on the meta device is ROADMAP queue A item 3b; what a
step of a ``pp x dp x tp`` mesh hands to collectives is
:func:`collective_stats` with its ``dp`` and ``tp``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, cell_is_skipped,
                                 get_config, get_shape)
from repro_torch.configs.base import (OptimizerConfig, ParallelPlan,
                                      RecomputeConfig, ShapeConfig)
from repro_torch.roofline import analysis
from repro_torch.roofline.analysis import (CollectiveStats, WorkCount,
                                           cost_to_roofline, count_work,
                                           model_flops_for)
from repro_torch.tree import tree_leaves

RESULTS = os.environ.get(
    "DRYRUN_RESULTS",
    str(Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"))
CARD_BYTES = 80e9               # an H100's 80 GB
PLANNER_RESERVE = 2.0e9         # PlannerQuery's default reserve
SERVE_CHUNK = 2048              # prefill tokens a chunk (serving shapes)
MICROBATCH = 2                  # sequences a microbatch (default_plan's)


def default_plan() -> ParallelPlan:
    """The reference's ``default_plan`` as the port's plan (the fused
    kernels; ZeRO and the pipeline axis have no meaning on one card)."""
    return ParallelPlan(
        schedule="chronos", num_chunks=2,
        microbatch_size=MICROBATCH,
        recompute=RecomputeConfig(mode="chronos", num_recomp_chunks=1),
        kernels="fused")


def budget_plan(cfg, shape: ShapeConfig, P: int,
                hbm_gb: float) -> ParallelPlan:
    """The planner's pick for ``P`` virtual stages of ``hbm_gb`` GB each
    (``--plan-hbm-gb``)."""
    from repro_torch.plan import plan_under_budget
    ep = plan_under_budget(
        cfg, pp=P, tp=1, hbm_bytes=hbm_gb * 1e9,
        microbatch=MICROBATCH,
        seq_len=shape.seq_len)
    print(f"[plan] {cfg.name}: {ep.summary()}")
    return ep.parallel_plan()


# ---------------------------------------------------------------------------
# counting a step
# ---------------------------------------------------------------------------

def memoized(cls):
    """``cls`` (an executor class) whose ops and sends each run once per
    key and replay their count into the running count after that (it
    raises outside :func:`count_work`): an op's key is the executor's
    ``op_key`` (two ops of one key run the same aten ops on tensors of
    the same shapes, whatever microbatch they carry); a send's, its ring
    and device.  For the meta device only: a replayed op computes
    nothing."""

    class Memoized(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.memo = {}

        def _replay(self, key, run):
            if analysis.ACTIVE is None:
                raise RuntimeError("a memoized executor runs only under "
                                   "count_work()")
            count = analysis.ACTIVE.count
            if key in self.memo:
                delta, out = self.memo[key]
                count.add(delta)
                return out
            before = count.copy()
            out = run()
            self.memo[key] = (count - before, out)
            return out

        def _op(self, d, row, *args):
            return self._replay(("op",) + self.op_key(d, row),
                                lambda: super(Memoized, self)._op(
                                    d, row, *args))

        def _put(self, name, d, c, slot, payload):
            return self._replay(("put", name, d, c), lambda: super(
                Memoized, self)._put(name, d, c, slot, payload))

    return Memoized


def _batch(cfg, seq_len: int, m: int, mbB: int, device, seed: int = 1):
    """A batch of ``m`` microbatches of ``mbB`` sequences as the training
    steps read it (tokens int32, a VLM's patch or an encoder-decoder's
    frame embeddings fp32): the synthetic stream's on a real device,
    empty tensors of the same shapes on meta."""
    dev = torch.device(device)
    extra = {}
    if cfg.vision is not None:
        extra["patch_embeds"] = (cfg.vision.num_patches, cfg.d_model)
    if cfg.encdec is not None:
        extra["frame_embeds"] = (cfg.encdec.num_frames, cfg.d_model)
    if dev.type == "meta":
        out = {"tokens": torch.empty((m, mbB, seq_len), dtype=torch.int32,
                                     device=dev)}
        for k, shape in extra.items():
            out[k] = torch.empty((m, mbB) + shape, dtype=torch.float32,
                                 device=dev)
        return out
    from repro_torch.data import synthetic_source
    flat = synthetic_source(cfg, seq_len, seed=seed).next_batch(m * mbB)
    if not isinstance(flat, dict):
        flat = {"tokens": flat}
    return {k: torch.from_numpy(a.reshape((m, mbB) + a.shape[1:])).to(dev)
            for k, a in flat.items()}


def _generator(device):
    """A seeded generator on a real device; None on meta (shapes only)."""
    dev = torch.device(device)
    return None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(0)


def build_pipeline(cfg, shape: ShapeConfig, plan: ParallelPlan,
                   ocfg: OptimizerConfig, P: int, device="meta",
                   wrap_executor=None):
    """The pipeline step and everything it reads, built on ``device``:
    ``(step, args, spec)`` with ``step(*args)`` one training step."""
    from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                                   init_psum_ef)
    from repro_torch.launch.steps import (make_pipeline_train_step,
                                          offload_kept, psum_bits_of)
    from repro_torch.optim.adamw import adamw_init
    step, m, mbB, spec = make_pipeline_train_step(
        cfg, shape, plan, ocfg, P=P, device=device,
        wrap_executor=wrap_executor)
    params = init_pipeline_params(_generator(device), cfg, spec.layout,
                                  device)
    offload = plan.offload.enabled and plan.offload.num_offload_chunks > 0
    opt_state = adamw_init(offload_kept(params, plan)[0] if offload
                           else params)
    args = (params, opt_state, _batch(cfg, shape.seq_len, m, mbB, device))
    if psum_bits_of(plan):
        args += (init_psum_ef(spec, params),)
    return step, args, spec


def count_pipeline_step(cfg, shape: ShapeConfig, plan: ParallelPlan,
                        ocfg: OptimizerConfig, P: int,
                        device="meta") -> WorkCount:
    """The work of one ``train_pipeline`` step over ``P`` virtual stages:
    on the meta device each distinct op once (:func:`memoized`), on a
    real device every op run."""
    meta = torch.device(device).type == "meta"
    step, args, _ = build_pipeline(cfg, shape, plan, ocfg, P, device,
                                   memoized if meta else None)
    with count_work() as c:
        step(*args)
    return c


def count_single_step(cfg, shape: ShapeConfig, plan: ParallelPlan,
                      ocfg: OptimizerConfig, device="meta") -> WorkCount:
    """The work of one ``train()`` step (``global_batch //
    microbatch_size`` microbatches): on a real device, and on the meta
    device for up to two microbatches, the whole step; on the meta device
    for more, the step at one and at two microbatches, the difference
    being one microbatch's ``LM.loss``, its gradient and its sum into the
    fp32 buffers, extended to all of them."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import adamw_init
    mbB = plan.microbatch_size
    m = max(1, shape.global_batch // mbB)
    meta = torch.device(device).type == "meta"
    counts = []
    for mm in ((1, 2) if meta and m > 2 else (m,)):
        step, lm = make_train_step(cfg, plan, ocfg, mm, device=device)
        params = lm.init(_generator(device))
        args = (params, adamw_init(params),
                _batch(cfg, shape.seq_len, mm, mbB, device))
        with count_work() as c:
            step(*args)
        counts.append(c)
    if len(counts) == 1:
        return counts[0]
    return counts[0].copy().add(counts[1] - counts[0], m - 1)


def count_serve(cfg, shape: ShapeConfig, device="meta"):
    """The work of serving ``shape`` with the LM (fused kernels): a
    prefill shape runs its prompt in chunks of :data:`SERVE_CHUNK` tokens
    (the
    first one with a VLM's patches or an encoder-decoder's frames), a
    decode shape one step at the last position of a full cache, each for
    the shape's whole batch.  Returns ``(count, lm, params, cache)``."""
    from repro_torch.models import LM
    lm = LM(cfg, kernels="fused", device=device)
    params = lm.init(_generator(device))
    Bz, S = shape.global_batch, shape.seq_len
    cache = lm.init_cache(Bz, S)
    dev = lm.device
    with torch.no_grad(), count_work() as c:
        if shape.kind == "prefill":
            for pos0 in range(0, S, SERVE_CHUNK):
                n = min(SERVE_CHUNK, S - pos0)
                kw = {}
                if pos0 == 0:
                    emb = _batch(cfg, 1, 1, Bz, dev)
                    kw = {k: v[0] for k, v in emb.items() if k != "tokens"}
                tok = torch.zeros((Bz, n), dtype=torch.int32, device=dev)
                lm.prefill_chunk(params, tok, cache, pos0, **kw)
        else:
            tok = torch.zeros((Bz, 1), dtype=torch.int32, device=dev)
            lm.decode_step(params, tok, cache, S - 1)
    return c, lm, params, cache


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

def _nbytes(a) -> int:
    return a.numel() * a.element_size()


def static_bytes(params, opt_state, P: int) -> Dict:
    """What the port holds for a pipeline run, from the built trees:
    weights, gradient accumulators (a block leaf's in its own dtype, a
    shared leaf's in fp32, as the executor makes them) and the fp32
    optimizer state (master, mu, nu); per virtual stage (block leaves
    ``[P, ...]``) and shared (held once)."""
    blocks = tree_leaves(params["blocks"])
    shared = [a for k, v in params.items() if k != "blocks"
              for a in tree_leaves(v)]
    opt = [a for k in ("master", "mu", "nu") for a in
           tree_leaves(opt_state[k])]
    w_blk = sum(_nbytes(a) for a in blocks)
    w_sh = sum(_nbytes(a) for a in shared)
    g_blk, g_sh = w_blk, sum(4 * a.numel() for a in shared)
    n_sh = sum(a.numel() for a in shared)
    o_sh = 12 * n_sh
    o_blk = sum(_nbytes(a) for a in opt) - o_sh
    per_stage = (w_blk + g_blk + o_blk) // P
    return {"weights": w_blk + w_sh, "grads": g_blk + g_sh,
            "optimizer": o_blk + o_sh, "per_stage": per_stage,
            "shared": w_sh + g_sh + o_sh,
            "total": w_blk + w_sh + g_blk + g_sh + o_blk + o_sh,
            "params": sum(a.numel() for a in blocks) + n_sh}


def predicted_card_peak(cfg, shape: ShapeConfig, plan: ParallelPlan,
                        P: int):
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
    m = plan.num_microbatches or max(
        2, shape.global_batch // plan.microbatch_size)
    kw = plan_schedule_kwargs(plan)
    if plan.schedule in SEQ_SCHEDULES:
        kw["n_seq"] = plan.seq_chunks
    if plan.schedule in _SCHEDULES_WITH_V:
        kw["v"] = plan.num_chunks
    sched = get_schedule(plan.schedule, P, m, **kw)
    mm = MemoryModel.build(cfg)
    L, tokens = cfg.num_layers, plan.microbatch_size * shape.seq_len
    off = plan.offload.num_offload_chunks / plan.num_chunks \
        if plan.offload.enabled else 0.0
    state = P * mm.model_state(L, P, 1, offload_frac=off)
    act = sum(sched.peak_activation(per_stage=True)) * mm.m_a(tokens, L)
    kv = 0.0
    if sched.n_seq > 1:
        kv_frac = _metrics(plan.schedule, P, m, tuple(sorted(kw.items())))[4]
        kv = P * 2.0 * kv_frac * mm.kv_a(tokens, L)
    return state + act + kv + PLANNER_RESERVE, state, act, kv


def collective_stats(spec, dp: int = 1, tp: int = 1, *,
                     masked: bool = False, update: bool = True,
                     zero_stage: int = 1,
                     offload_chunks: int = 0) -> CollectiveStats:
    """What one step hands to collectives when its stages are ``P``
    ranks (:func:`repro_torch.core.pipeline_runtime.make_train_grads_fn`
    with a mesh), summed over the ranks: the boundary payloads sent
    across stages (``collective-permute``: sends and bytes, each payload
    as the wire stores it), and the shared-gradient sum (``all-reduce``:
    every rank's fp32 leaves, or under ``grad_psum_bits`` each leaf's
    fp32 amax and its int32 codes; calls counted per rank).

    On a ``P x dp x tp`` mesh (dp or tp > 1) every pipe of ``dp * tp``
    carries its own sends and shared-gradient sum (of its tp shards),
    and three kinds join them (:func:`_mesh_collectives`):
    ``all-reduce-tp``, the activations' tensor-parallel sums of a step's
    F, B and W ops (B and W recompute their chunk under autograd, so the
    forward's sums run again there, beside the backward's);
    ``all-reduce-dp``, every gradient summed over dp; ``all-gather-dp``,
    the ZeRO-1 weights (none at ``zero_stage`` 0); with MoE layers under
    dp, ``all-gather-route``, their expert counts in every op that runs
    the chunk's forward; with K/V heads replicated over tp,
    ``all-reduce-kv``, their gradients summed over each K/V group once a
    step (counted under "model").  An encoder-decoder's ``all-reduce-tp``
    holds its encoder's sums where an op runs it and its
    cross-attentions'.  At ``zero_stage`` 3
    the block leaves held as dp slices leave those two, and two kinds
    count them instead: ``all-gather-fsdp``, each F, B and W op's gather
    of its chunk's slices, and ``reduce-scatter-fsdp``, each B or W op's
    gradients of the whole chunk.  ``by_axis`` then
    holds each axis's bytes with the scalars (the loss and count, the
    clip norm's sums with ``update``, each microbatch's mask count over
    dp with ``masked``): what the ranks' counters read, which phase 28
    and the mesh tests gate on.

    ``offload_chunks`` (Chronos-Offload of that many deepest chunks, on
    the mesh): the ZeRO-1 all-gather splits in two, the kept leaves'
    within the step (``all-gather-dp``, each laid out on the kept part's
    shapes) and the deep leaves' after the host update's upload
    (``all-gather-deep``, on the deep part's), which
    ``train_pipeline(mesh=)`` counts in the step that shipped them; under ``grad_psum_bits`` the shipment's
    amaxes, one fp32 a deep leaf, are all-reduced over every axis of more
    than one rank (``all-reduce-amax``, its bytes under each axis)."""
    from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                                   stage_crossing_sends)
    sends, nbytes = stage_crossing_sends(spec)
    P = spec.table.P
    if dp * tp > 1:
        mc = _mesh_collectives(spec, dp, tp, masked, update, zero_stage,
                               offload_chunks)
        kinds = {"collective-permute": (dp * tp * nbytes, dp * tp * sends),
                 "all-reduce": (mc["pp"]["shared_bytes"],
                                mc["pp"]["shared_calls"]),
                 "all-reduce-tp": (mc["model"]["bytes"],
                                   mc["model"]["calls"]),
                 "all-reduce-dp": (mc["data"]["grad_bytes"],
                                   mc["data"]["grad_calls"]),
                 "all-gather-dp": (mc["data"]["gather_bytes"],
                                   mc["data"]["gather_calls"])}
        if mc["data"]["route_calls"]:
            kinds["all-gather-route"] = (mc["data"]["route_bytes"],
                                         mc["data"]["route_calls"])
        if mc["model"]["kv_calls"]:
            kinds["all-reduce-kv"] = (mc["model"]["kv_bytes"],
                                      mc["model"]["kv_calls"])
        if offload_chunks:
            kinds["all-gather-deep"] = (mc["data"]["deep_gather_bytes"],
                                        mc["data"]["deep_gather_calls"])
            if spec.grad_psum_bits:
                kinds["all-reduce-amax"] = (
                    sum(mc[a]["amax_bytes"] for a in mc),
                    sum(mc[a]["amax_calls"] for a in mc))
        if zero_stage >= 3:
            kinds["all-gather-fsdp"] = (mc["data"]["fsdp_gather_bytes"],
                                        mc["data"]["fsdp_gather_calls"])
            kinds["reduce-scatter-fsdp"] = (mc["data"]["fsdp_rs_bytes"],
                                            mc["data"]["fsdp_rs_calls"])
        return CollectiveStats({k: float(b) for k, (b, _) in kinds.items()},
                               {k: c for k, (_, c) in kinds.items()},
                               {a: v["total"] for a, v in mc.items()})
    params = init_pipeline_params(None, spec.cfg, spec.layout, "meta")
    shared = [a.numel() for k, v in params.items() if k != "blocks"
              for a in tree_leaves(v)]
    n_calls = len(shared) * (2 if spec.grad_psum_bits else 1)
    ar = 4 * sum(shared) + (4 * len(shared) if spec.grad_psum_bits else 0)
    return CollectiveStats(
        {"collective-permute": float(nbytes), "all-reduce": float(P * ar)},
        {"collective-permute": sends, "all-reduce": P * n_calls})


def train_collective_stats(cfg, *, m: int, mbB: int, seq_len: int,
                           dp: int, tp: int, zero_stage: int = 1,
                           masked: bool = False) -> CollectiveStats:
    """What one step of ``train()`` on a ``1 x dp x tp`` mesh
    (:func:`repro_torch.launch.steps.make_train_step` with a mesh) hands
    to collectives, summed over the ranks, by kind and by mesh axis:
    ``m`` microbatches of ``mbB`` sequences a rank of ``seq_len`` tokens.

    Per microbatch and rank, every period of the stack runs under its
    Chronos-Recomp checkpoint, whose recompute runs its forward's
    collectives again in the backward up to the last saved tensor (torch
    stops it there): all but the period's last MLP output sum.

    - ``all-reduce-tp``: each layer's tensor-parallel sums
      (:func:`layer_traffic`: attention, MLP, Mamba-2 and MoE outputs, the
      Mamba-2 norm's row sums) forward, again on a period's recompute but
      for the period's last output sum (the inputs of the products before
      it are the last saved tensors, and the sum comes after them), and
      the layers' backward sums; where tp divides the vocab, the lookup (in the
      parameters' dtype), the head's max, sum of exponentials and gold
      logit (fp32 ``[mbB, S]``) and its input's gradient;
    - ``all-gather-fsdp`` / ``reduce-scatter-fsdp`` (ZeRO-3): each leaf
      held as its dp slice gathered where it is used (a period's layer
      twice, forward and recompute; the tied embedding at the lookup and
      the head) and its gradient reduce-scattered once a use (the whole
      leaf's bytes), the leaves a use reads together in one call a
      dtype (a layer, the encoder, an embedding leaf);
    - ``all-gather-route``: each MoE layer's expert counts over dp, in
      the forward and the recompute;
    - ``reduce-scatter-dp`` / ``all-reduce-dp``: every other gradient
      leaf summed over dp into its state's slice, or whole where the
      state is whole;

    and per step the loss (4 B over dp), each microbatch's mask count
    (4 B each over dp, with ``masked``), the clip norm's sum (4 B over tp
    and over dp), below stage 3 the updated slices' all-gather over dp
    (``all-gather-dp``), and the replicated K/V heads' fp32 gradient
    sums over their K/V groups (``all-reduce-kv``, under "model").  An
    encoder-decoder adds its encoder's tp sums (once a microbatch: the
    encoder runs outside the checkpoints) and each layer's
    cross-attention's (its encoder input's gradient among them)."""
    from repro_torch.launch.mesh import MESH_RULES
    from repro_torch.launch.steps import lm_shard
    from repro_torch.models import LM
    from repro_torch.models.transformer import _dtype
    shard = lm_shard(cfg, {"pp": 1, "data": dp, "model": tp}, MESH_RULES,
                     {"pp": 0, "data": 0, "model": 0}, zero_stage)
    tree = LM(cfg, device="meta").init(None)
    S, d = seq_len - 1, cfg.d_model
    act = mbB * S * d * _dtype(cfg.compute_dtype).itemsize
    n = dp * tp
    kinds = {k: [0, 0] for k in ("all-reduce-tp", "all-gather-route",
                                 "all-gather-fsdp",
                                 "reduce-scatter-fsdp", "reduce-scatter-dp",
                                 "all-reduce-dp", "all-gather-dp")}

    def add(kind, nbytes, calls=1):
        kinds[kind][0] += nbytes
        kinds[kind][1] += calls
    nper = cfg.num_layers // cfg.period
    T = cfg.encdec.num_frames if cfg.encdec is not None else 0
    # the stack runs over a VLM's patches and the tokens, the head and the
    # lookup over the tokens
    pre = cfg.vision.num_patches if cfg.vision is not None else 0
    for idx in range(cfg.num_layers):
        lt = layer_traffic(cfg, idx, tp, dp, mbB * (pre + S), mbB * T)
        stacked = idx < nper * cfg.period
        # a stacked layer's forward runs again in its period's recompute,
        # but for the period's last output sum
        last = lt["last"] if stacked and idx % cfg.period \
            == cfg.period - 1 else 0
        runs = 2 if stacked else 1
        if lt["fwd"][1] or lt["bwd"][1]:
            add("all-reduce-tp", runs * lt["fwd"][0] - last + lt["bwd"][0]
                + lt["kv_bwd"][0], runs * lt["fwd"][1] - (last > 0)
                + lt["bwd"][1] + lt["kv_bwd"][1])
        if lt["route"][1]:
            add("all-gather-route", runs * lt["route"][0],
                runs * lt["route"][1])
    enc = encoder_traffic(cfg, tp, mbB * T)       # once, unwrapped
    for k in ("fwd", "bwd"):
        if enc[k][1]:
            add("all-reduce-tp", *enc[k])
    if tp > 1:
        if cfg.vocab_size % tp == 0:
            add("all-reduce-tp", mbB * S * d * _dtype(cfg.param_dtype)
                .itemsize)
            add("all-reduce-tp", 3 * mbB * S * 4, 3)
            add("all-reduce-tp", act)
    if dp > 1:
        units: Dict[tuple, list] = {}     # what one gather call reads
        for i, (path, a) in enumerate(zip(shard.paths, tree_leaves(tree))):
            numel = a.numel() // shard.tp_parts[i]
            nbytes = numel * a.element_size()
            if shard.fsdp_dims[i] is not None:
                key = path[:1] if path[0] == "encoder" else path[:2]
                units.setdefault(key, []).append((nbytes, a.dtype))
            elif shard.zero_dims[i] is not None:
                add("reduce-scatter-dp", nbytes)
            else:
                add("all-reduce-dp", nbytes)
        for key, leaves in units.items():
            nbytes = sum(b for b, _ in leaves)
            calls = len({dt for _, dt in leaves})
            # the uses a microbatch: a period position's layers in each
            # period, forward and recompute; the tied embedding twice
            if key[0] == "layers":
                uses, gathers, nbytes = nper, 2 * nper, nbytes // nper
            else:
                uses = 1 + (key == ("embed", "tokens")
                            and cfg.tie_embeddings)
                gathers = uses
            add("all-gather-fsdp", gathers * nbytes // dp, gathers * calls)
            add("reduce-scatter-fsdp", uses * nbytes, uses * calls)
    per_mb = {k: v for k, v in kinds.items() if k != "all-gather-dp"}
    kinds = {k: [b * m * n, c * m * n] for k, (b, c) in per_mb.items()}
    gather_b = gather_c = 0
    if dp > 1:
        for i, a in enumerate(tree_leaves(tree)):
            if shard.zero_dims[i] is not None and shard.fsdp_dims[i] is None:
                numel = a.numel() // shard.tp_parts[i]
                gather_b += numel // dp * a.element_size()
                gather_c += 1
    kinds["all-gather-dp"] = [gather_b * n, gather_c * n]
    # the replicated K/V heads' fp32 gradient sums (the state's dp slices)
    # over their K/V groups, once a step
    kv_b, kv_c = kv_sum_traffic(shard, tree, lambda i, path, a, numel: 4 * (
        numel // dp if shard.zero_dims[i] is not None else numel))
    kinds["all-reduce-kv"] = [kv_b * n, kv_c * n]
    scalars_dp = (8 + 4 * m * masked) * n if dp > 1 else 0
    by_axis = {"pp": 0,
               "data": sum(kinds[k][0] for k in kinds
                           if k not in ("all-reduce-tp", "all-reduce-kv"))
               + scalars_dp,
               "model": kinds["all-reduce-tp"][0] + kinds["all-reduce-kv"][0]
               + (4 * n if tp > 1 else 0)}
    return CollectiveStats({k: float(b) for k, (b, _) in kinds.items()},
                           {k: c for k, (_, c) in kinds.items()}, by_axis)


def layer_traffic(cfg, idx: int, tp: int, dp: int, tokens: int,
                  enc_tokens: int = 0) -> Dict:
    """What decoder layer ``idx`` hands to collectives in one forward and
    one backward over ``tokens`` tokens (a microbatch a rank; an
    encoder-decoder's ``enc_tokens`` encoder positions), per rank:

    - ``fwd`` / ``bwd``: ``(bytes, calls)`` of its tensor-parallel sums
      (all-reduces over tp; none at tp 1).  Forward: the attention's and
      the Mamba-2 block's output ``[tokens, d]`` in the compute dtype, the
      Mamba-2 gated norm's fp32 ``[tokens]`` sums of squares, an MLP's
      output where tp divides its width, an MoE layer's combined expert
      (and shared) outputs where tp divides the experts' width, else the
      shared experts' own where tp divides theirs.  Backward: the inputs'
      gradients of every split product (``[tokens, d]`` each), the
      Mamba-2 block's replicated B and C (``[tokens, N]`` each) and its
      norm's fp32 ``[tokens]`` row sums, and the MoE gates (fp32
      ``[tokens * k]``) where the experts are split.  An encoder-decoder
      layer's cross-attention adds its output forward and its query
      input's gradient backward;
    - ``kv_bwd``: ``(bytes, calls)`` of the cross-attention's encoder
      input's gradient (``[enc_tokens, d]``), summed over tp where the
      encoder output needs a gradient (not in a W op that does not run
      the encoder);
    - ``last``: the bytes of the layer's final output sum (the last
      collective of its forward, after which it saves no tensor: a
      Chronos-Recomp checkpoint's recompute stops before it), or 0;
    - ``route``: ``(bytes, calls)`` over dp a forward: an MoE layer's
      all-gather of its int64 ``[E]`` expert counts (dp > 1)."""
    from repro_torch.models.transformer import _dtype
    d = cfg.d_model
    cdt = _dtype(cfg.compute_dtype).itemsize
    act = tokens * d * cdt
    fwd, bwd, kv_bwd = [0, 0], [0, 0], [0, 0]
    last = 0

    def add(acc, nbytes, calls=1):
        acc[0] += nbytes
        acc[1] += calls
    if tp > 1:
        if cfg.layer_kind(idx) == "attn":
            add(fwd, act)
            add(bwd, act)
        else:
            add(fwd, act + 4 * tokens, 2)
            add(bwd, act + 2 * tokens * cfg.ssm.state_dim * cdt
                + 4 * tokens, 4)
        if cfg.encdec is not None:
            add(fwd, act)
            add(bwd, act)
            add(kv_bwd, enc_tokens * d * cdt)
        last = act
        moe = cfg.moe if cfg.layer_is_moe(idx) else None
        if moe is not None:
            experts = moe.d_ff_expert % tp == 0
            ff = moe.num_shared_experts * moe.d_ff_shared
            shared = ff > 0 and ff % tp == 0
            if experts:
                add(fwd, act)
                add(bwd, act + 4 * tokens * moe.top_k, 2)
            elif shared:
                add(fwd, act)
                add(bwd, act)
            last = act if experts or shared else 0
        elif cfg.d_ff:
            split = cfg.d_ff % tp == 0
            if split:
                add(fwd, act)
                add(bwd, act)
            last = act if split else 0
    route = [0, 0]
    if dp > 1 and cfg.layer_is_moe(idx):
        add(route, 8 * cfg.moe.num_experts)
    return {"fwd": tuple(fwd), "bwd": tuple(bwd), "last": last,
            "route": tuple(route), "kv_bwd": tuple(kv_bwd)}


def encoder_traffic(cfg, tp: int, enc_tokens: int) -> Dict:
    """What an encoder-decoder's encoder hands to collectives over tp in
    one forward and one backward over ``enc_tokens`` positions, per rank:
    ``fwd`` / ``bwd`` ``(bytes, calls)``, each layer's attention output
    and its input's gradient, and its MLP's where tp divides ``d_ff``
    (``[enc_tokens, d]`` in the compute dtype each); zeros without an
    encoder or tp."""
    from repro_torch.models.transformer import _dtype
    if cfg.encdec is None or tp <= 1:
        return {"fwd": (0, 0), "bwd": (0, 0)}
    act = enc_tokens * cfg.d_model * _dtype(cfg.compute_dtype).itemsize
    n = cfg.encdec.num_encoder_layers * (1 + (cfg.d_ff % tp == 0))
    return {"fwd": (n * act, n), "bwd": (n * act, n)}


def kv_sum_traffic(shard, tree, nbytes) -> Tuple[int, int]:
    """``(bytes, calls)`` a rank hands to the sums of its replicated K/V
    heads' gradients over their K/V groups once a step
    (:meth:`~repro_torch.models.sharding.TreeShard.kv_sum`), one call a
    K/V leaf: ``nbytes(i, path, leaf, numel)`` the bytes of leaf ``i``'s
    gradient as the rank sums it, ``numel`` the rank's part of the
    global ``leaf`` of ``tree`` (a block leaf's pp column)."""
    nb = nc = 0
    for i, (path, a) in enumerate(zip(shard.paths, tree_leaves(tree))):
        if shard.kv[i]:
            numel = (a[0].numel() if path[0] == "blocks" else a.numel()) \
                // shard.tp_parts[i]
            nb += nbytes(i, path, a, numel)
            nc += 1
    return nb, nc


def _tp_units(spec, tp: int, d: int):
    """One device column's tensor-parallel all-reduces of a step, as
    ``(bytes, calls)`` per rank: its F, B and W ops (and the head's and
    the embedding's at the pipeline ends), from the table."""
    from repro_torch.core.tasktable import F_OPS, IDLE, R_OPS, W_OPS
    from repro_torch.models.transformer import _dtype
    cfg, tab = spec.cfg, spec.table
    A = tab.arrays()
    B, S, dm = spec.mbB, spec.S, cfg.d_model
    cdt = _dtype(cfg.compute_dtype).itemsize
    pdt = _dtype(cfg.param_dtype).itemsize
    # the head and the lookup see the tokens, not a VLM's patches
    St = S - spec.prefix
    act = B * St * dm * cdt
    # a chunk's forward sums and a backward's (which also recomputes the
    # forward): each of its layers' (:func:`layer_traffic`); the cross-
    # attention's encoder-input gradients where the enc payload needs one
    fb = fc = bb = bc = kb = kc = 0
    for j in range(spec.layout.period):
        lt = layer_traffic(cfg, j, tp, 1, B * S, B * spec.enc_len)
        fb += spec.layout.M * lt["fwd"][0]
        fc += spec.layout.M * lt["fwd"][1]
        bb += spec.layout.M * (lt["fwd"][0] + lt["bwd"][0])
        bc += spec.layout.M * (lt["fwd"][1] + lt["bwd"][1])
        kb += spec.layout.M * lt["kv_bwd"][0]
        kc += spec.layout.M * lt["kv_bwd"][1]
    enc = encoder_traffic(cfg, tp, B * spec.enc_len)
    vocab = cfg.vocab_size % tp == 0
    tot_b = tot_c = 0
    for t in range(tab.T):
        op, c = int(A[t, d, 0]), int(A[t, d, 1])
        if op == IDLE or op in R_OPS:
            continue
        s = spec.layout.pl.stage(d, c)
        first = c == 0 and s == 0
        last = c == tab.v - 1 and s == tab.P - 1
        fwd = op in F_OPS
        if not fwd and op not in W_OPS and tab.has_w and first:
            continue                     # the first block's split B: none
        b, calls = (fb, fc) if fwd else (bb, bc)
        if not fwd and (first or op not in W_OPS):
            # the enc input needs a gradient: a B op's payload, or the
            # encoder the first block's W op runs
            b, calls = b + kb, calls + kc
        embeds = first and (fwd or op in W_OPS or not tab.has_w)
        if embeds:
            # the encoder, run where the microbatch is embedded
            for k in ("fwd",) if fwd else ("fwd", "bwd"):
                b, calls = b + enc[k][0], calls + enc[k][1]
        if embeds and vocab:
            b, calls = b + B * St * dm * pdt, calls + 1     # the lookup
        if last and vocab:
            # max, sum of exponentials, gold logit; backward: dh
            b, calls = b + 3 * B * St * 4, calls + 3
            if not fwd:
                b, calls = b + act, calls + 1
        tot_b += b
        tot_c += calls
    return tot_b, tot_c


def _route_units(spec, dp: int, d: int):
    """One device column's MoE routing all-gathers over dp a step, per
    rank: ``(bytes, calls)``, a chunk's MoE layers' in every op that runs
    its forward (F, B and W; a split table's first-block B runs
    nothing)."""
    nb = nc = 0
    for j in range(spec.layout.period):
        b, c = layer_traffic(spec.cfg, j, 1, dp, 1)["route"]
        nb += spec.layout.M * b
        nc += spec.layout.M * c
    gathers, _ = _fsdp_units(spec, d)
    return gathers * nb, gathers * nc


def _fsdp_units(spec, d: int):
    """One device column's ZeRO-3 traffic over dp a step, per rank:
    ``(gathers, reduce-scatters)``, the ops that gather the chunk's
    slices (F, B and W; a split table's first-block B runs nothing) and
    those that reduce-scatter its gradients (W, and B where the table
    has no W)."""
    from repro_torch.core.tasktable import F_OPS, IDLE, R_OPS, W_OPS
    tab = spec.table
    A = tab.arrays()
    gathers = scatters = 0
    for t in range(tab.T):
        op, c = int(A[t, d, 0]), int(A[t, d, 1])
        if op == IDLE or op in R_OPS:
            continue
        first = c == 0 and spec.layout.pl.stage(d, c) == 0
        if op in F_OPS or op in W_OPS:
            gathers += 1
            scatters += op in W_OPS
        elif not tab.has_w:
            gathers += 1
            scatters += 1
        elif not first:
            gathers += 1
    return gathers, scatters


def _mesh_collectives(spec, dp: int, tp: int, masked: bool, update: bool,
                      zero_stage: int,
                      offload_chunks: int = 0) -> Dict[str, Dict[str, int]]:
    """The bytes and calls one training step of ``spec`` on a ``P x dp x
    tp`` mesh hands to collectives, by mesh axis, summed over the ranks
    (:class:`repro_torch.launch.mesh.Mesh` counts the same per rank):

    - ``pp``: the packed payloads sent (``send_bytes``), the shared
      gradients' sum (``shared_bytes``, each rank's tp shard in fp32),
      and the scalars (the loss and count, 8 B; with ``update`` the
      clip norm's block sum, 4 B);
    - ``data``: every gradient leaf of the rank (``grad_bytes``: blocks
      in their dtype, shared in fp32), the ZeRO-1 weights' all-gather
      (``gather_bytes``: each rank's dp slices, none at ``zero_stage``
      0); at stage 3, for the block leaves held as dp slices, instead of
      those the ops' gathers (``fsdp_gather_bytes``: the chunk's slices)
      and reduce-scatters (``fsdp_rs_bytes``: the chunk's whole
      gradients, in the leaves' dtype), one call a dtype an op
      (:func:`_fsdp_units`); and the
      scalars (loss
      and count, 8 B; the norm, 4 B; with ``masked`` each microbatch's
      mask count, 4 B);
    - ``model``: the activations' sums (``bytes``, :func:`_tp_units`)
      and the norm's 4 B.

    ``total`` per axis is what the ranks' counters read
    (:attr:`CollectiveStats.by_axis`)."""
    from repro_torch.core.pipeline_runtime import (RankShard,
                                                   init_pipeline_params,
                                                   payload_words,
                                                   stage_crossing_sends)
    from repro_torch.launch.mesh import MESH_RULES
    P, m = spec.table.P, spec.table.m
    sends, _ = stage_crossing_sends(spec)
    n = P * dp * tp
    send_bytes = dp * tp * sends * 2 * payload_words(spec) * spec.mbB
    tree = init_pipeline_params(None, spec.cfg, spec.layout, "meta")
    shard = RankShard(spec.cfg, spec.layout, {"pp": P, "data": dp,
                                              "model": tp}, MESH_RULES,
                      {"pp": 0, "data": 0, "model": 0}, zero_stage)
    shared_b = grad_b = gather_b = 0
    shared_c = grad_c = gather_c = 0
    chunk_b = 0                     # one chunk's dp slices (ZeRO-3)
    chunk_dtypes = set()            # one collective a dtype
    for i, (path, a, sp) in enumerate(zip(shard.paths, tree_leaves(tree),
                                          shard.param_specs)):
        numel = (a[0].numel() if path[0] == "blocks" else a.numel()) \
            // shard.tp_parts[i]
        if shard.fsdp_dims[i] is not None:
            chunk_b += numel // dp // spec.table.v * a.element_size()
            chunk_dtypes.add(a.dtype)
            continue
        if path[0] == "blocks":
            grad_b += numel * a.element_size()
            if not offload_chunks and shard.zero_dims[i] is not None \
                    and dp > 1:
                gather_b += numel // dp * a.element_size()
                gather_c += 1
        else:
            grad_b += 4 * numel
            shared_b += 4 * numel + (4 if spec.grad_psum_bits else 0)
            shared_c += 2 if spec.grad_psum_bits else 1
        grad_c += 1
    fsdp = {"fsdp_gather_bytes": 0, "fsdp_gather_calls": 0,
            "fsdp_rs_bytes": 0, "fsdp_rs_calls": 0}
    chunk_c = len(chunk_dtypes)
    if chunk_c:
        for d in range(P):
            g, r = _fsdp_units(spec, d)
            fsdp["fsdp_gather_bytes"] += g * chunk_b * dp * tp
            fsdp["fsdp_gather_calls"] += g * chunk_c * dp * tp
            fsdp["fsdp_rs_bytes"] += r * chunk_b * dp * dp * tp
            fsdp["fsdp_rs_calls"] += r * chunk_c * dp * tp
    model_b = model_c = 0
    if tp > 1:
        for d in range(P):
            b, c = _tp_units(spec, tp, d)
            model_b += b * dp * tp
            model_c += c * dp * tp
    # the replicated K/V heads' gradients over their K/V groups: as the
    # tick loop leaves them, a block leaf in its dtype (fp32, its dp
    # slice, where it is held as one), a shared one in fp32
    kv_b, kv_c = kv_sum_traffic(shard, tree, lambda i, path, a, numel: (
        4 * numel // dp if shard.fsdp_dims[i] is not None else
        numel * (a.element_size() if path[0] == "blocks" else 4)))
    route_b = route_c = 0
    if dp > 1:
        for d in range(P):
            b, c = _route_units(spec, dp, d)
            route_b += b * dp * tp
            route_c += c * dp * tp
    deep_b = deep_c = amax = 0
    if offload_chunks:
        # the kept and the deep parts' ZeRO-1 all-gathers, each laid out
        # on its own shapes (a state cut over dp on the chunk axis of the
        # whole tree is whole on a part of one chunk)
        cut = spec.table.v - offload_chunks
        elsize = {path: a.element_size()
                  for path, a in zip(shard.paths, tree_leaves(tree))}
        for chunks, shared in ((slice(0, cut), True),
                               (slice(cut, None), False)):
            part = RankShard(spec.cfg, spec.layout, {
                "pp": P, "data": dp, "model": tp}, MESH_RULES,
                {"pp": 0, "data": 0, "model": 0}, zero_stage,
                chunks=chunks, shared=shared)
            b = c = 0
            for i, (path, sh) in enumerate(zip(part.paths, part.shapes)):
                if path[0] != "blocks" or part.fsdp_dims[i] is not None \
                        or part.zero_dims[i] is None or dp == 1:
                    continue
                b += math.prod(sh[1:]) // part.tp_parts[i] // dp \
                    * elsize[path]
                c += 1
            if shared:
                gather_b, gather_c = b, c
            else:
                deep_b, deep_c = b, c
                amax = 4 * len(part.paths) if spec.grad_psum_bits else 0
    pp_scalar = (8 + 4 * update) if P > 1 else 0
    out = {
        "pp": {"send_bytes": send_bytes, "sends": dp * tp * sends,
               "shared_bytes": shared_b * n if P > 1 else 0,
               "shared_calls": shared_c * n if P > 1 else 0,
               "scalar_bytes": pp_scalar * n},
        "data": {"grad_bytes": grad_b * n if dp > 1 else 0,
                 "grad_calls": grad_c * n if dp > 1 else 0,
                 "gather_bytes": gather_b * n if dp > 1 and update else 0,
                 "gather_calls": gather_c * n if dp > 1 and update else 0,
                 **fsdp,
                 "route_bytes": route_b, "route_calls": route_c,
                 "scalar_bytes": (8 + 4 * update + (4 * m if masked else 0))
                 * n if dp > 1 else 0,
                 "deep_gather_bytes": deep_b * n if dp > 1 else 0,
                 "deep_gather_calls": deep_c * n if dp > 1 else 0},
        "model": {"bytes": model_b, "calls": model_c,
                  "kv_bytes": kv_b * n, "kv_calls": kv_c * n,
                  "scalar_bytes": 4 * update * n if tp > 1 else 0}}
    for ax, size in (("pp", P), ("data", dp), ("model", tp)):
        on = amax and size > 1
        out[ax].update(amax_bytes=amax * n if on else 0,
                       amax_calls=n if on else 0)
    for ax, v in out.items():
        v["total"] = sum(x for k, x in v.items()
                         if k.endswith("bytes"))
    return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, P: int = 4,
             plan_hbm_gb: float = 0.0) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    skip = cell_is_skipped(cfg, shape)
    head = {"arch": arch, "shape": shape_name, "P": P}
    if skip:
        return {**head, "status": "skipped", "reason": skip}
    t0 = time.time()
    mf = model_flops_for(cfg, shape, shape.kind)
    if shape.kind == "train":
        plan = budget_plan(cfg, shape, P, plan_hbm_gb) if plan_hbm_gb > 0 \
            else default_plan()
        ocfg = OptimizerConfig()
        step, args, spec = build_pipeline(cfg, shape, plan, ocfg, P, "meta",
                                          memoized)
        static = static_bytes(args[0], args[1], P)
        with count_work() as count:
            step(*args)
        total, state, act, kv = predicted_card_peak(cfg, shape, plan, P)
        coll = collective_stats(spec)
        tab = spec.table
        out = {
            "kind": "train", "entry": "train_pipeline",
            "plan": {"schedule": plan.schedule, "v": plan.num_chunks,
                     "seq_chunks": plan.seq_chunks,
                     "microbatch_size": plan.microbatch_size,
                     "num_microbatches": tab.m,
                     "recompute": dataclasses.asdict(plan.recompute),
                     "offload_chunks": plan.offload.num_offload_chunks
                     if plan.offload.enabled else 0,
                     "L_pad": spec.layout.L_pad, "ticks": tab.T},
            "memory": {"static": static,
                       "predicted": {"total": total, "model_state": state,
                                     "activations": act, "kv_carry": kv},
                       "fits_80gb": total <= CARD_BYTES},
            "collectives": {"bytes_by_kind": coll.bytes_by_kind,
                            "count_by_kind": coll.count_by_kind}}
    else:
        coll = CollectiveStats({}, {})
        count, _, params, cache = count_serve(cfg, shape)
        w = sum(_nbytes(a) for a in tree_leaves(params))
        kv = sum(_nbytes(a) for a in tree_leaves(cache))
        out = {"kind": shape.kind, "entry": "LM.prefill_chunk"
               if shape.kind == "prefill" else "LM.decode_step",
               "chunk": SERVE_CHUNK if shape.kind == "prefill" else None,
               "memory": {"static": {"weights": w, "cache": kv,
                                     "total": w + kv},
                          "predicted": {"total": w + kv + PLANNER_RESERVE},
                          "fits_80gb": w + kv + PLANNER_RESERVE
                          <= CARD_BYTES}}
    roof = cost_to_roofline(count, coll, 1, mf)
    top = sorted(count.ops.items(), key=lambda kv: -kv[1][2])[:12]
    return {**head, "status": "ok", **out,
            "work": {**count.as_dict(), "top_ops_by_bytes": top},
            "roofline": roof.as_dict(), "chips": 1,
            "seconds": round(time.time() - t0, 2)}


def cell_path(arch: str, shape_name: str, tag: str) -> str:
    return os.path.join(RESULTS, f"{arch}__{shape_name}__{tag}.json")


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--P", type=int, default=4,
                    help="virtual pipeline stages on the one card")
    ap.add_argument("--plan-hbm-gb", type=float, default=0.0,
                    help="plan train cells with repro_torch.plan under "
                         "this per-stage HBM budget (GB) instead of the "
                         "fixed chronos default")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --all, or --arch and --shape")
    os.makedirs(RESULTS, exist_ok=True)
    tag = f"onecard_P{args.P}" + (f"_hbm{args.plan_hbm_gb:g}"
                                  if args.plan_hbm_gb > 0 else "")
    cells = [(a, s) for a in ARCH_IDS for s in SHAPES] if args.all \
        else [(args.arch, args.shape)]
    failures = 0
    for arch, shape_name in cells:
        path = cell_path(arch, shape_name, tag)
        if os.path.exists(path) and not args.force:
            print(f"[cached] {arch} x {shape_name}")
            continue
        print(f"=== {arch} x {shape_name} ({tag}) ===", flush=True)
        try:
            res = run_cell(arch, shape_name, P=args.P,
                           plan_hbm_gb=args.plan_hbm_gb)
        except Exception:
            failures += 1
            res = {"arch": arch, "shape": shape_name, "P": args.P,
                   "status": "error",
                   "error": traceback.format_exc()[-3000:]}
            print(res["error"])
        res["tag"] = tag
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        r = res.get("roofline")
        print(f"-> {res['status']}" + (
            f" ({res['seconds']} s): {r['flops_per_device']:.4g} FLOP, "
            f"{r['hbm_bytes_per_device']:.4g} B, dominant {r['dominant']}, "
            f"useful {r['useful_ratio']:.3f}" if r else ""), flush=True)
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
