"""Pipelined inference serving engine (port of ``repro/serve/engine.py``).

The model is split into ``P`` pipeline stages by :class:`StageLayout`
(v=1) and serves as a conveyor of per-tick waves:

- **prefill**: a prompt streams through the stages in sequence chunks of
  ``chunk`` tokens, back-to-back.  Each stage appends the chunk's K/V in
  the request's slot cache (a Mamba-2 layer carries its conv tails and
  SSM state there instead) and hands the boundary activation down the
  wire.  Every prefill chunk runs the flash-attention kernel in every
  attention layer and the SSD scan kernel, from the slot's carried
  state, in every Mamba-2 layer.
- **decode** rides steady-state ticks: a request slot re-enters the pipe
  one token at a time, one token per pipeline revolution (``P`` ticks),
  with every tick in between free for other slots' prefill chunks or
  decodes — continuous batching at iteration level.  Decode is S=1 and
  takes the dense attention path by design.

The reference runs one SPMD tick over a mesh of ``P`` devices.  Here the
``P`` stages are virtual and run in lockstep on one device: in each tick
stage ``s`` executes the injection made ``s`` ticks ago, and the wire
between stages is a ``[P, chunk, d]`` tensor hand-off.  Stages run from
the last to the first, so each reads the wire row its predecessor wrote
in the previous tick before that row is overwritten.  The greedy head
runs on the last stage, and only for waves whose token is consumed.

Fault seams (resilient serving, :mod:`repro_torch.serve.resilience`):
:meth:`PipelinedEngine.serve` drives a fault injector through its tick
seams, arms a watchdog around every tick and feeds a health monitor the
tick times; :meth:`PipelinedEngine.corrupt_slot` scribbles NaN over one
slot and :meth:`PipelinedEngine.rebuild_elastic` re-indexes the stage
blocks onto another depth.  A sampled wave whose logits are not all
finite counts in ``nonfinite_logits`` when the scheduler accepts its
token and in ``stale_nonfinite_logits`` when it rejects it as stale (a
wave of a corrupted slot's evicted tenant, still in the pipe, reads the
NaN cache; it reaches every stage before the re-admitted tenant's first
chunk zeroes that stage's slot, since each stage runs its waves in
injection order).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.layout import StageLayout
from repro_torch.core.pipeline_runtime import remap_blocks_elastic
from repro_torch.core.placement import Placement
from repro_torch.ft.health import Action
from repro_torch.ft.inject import DeviceLossError
from repro_torch.models.transformer import LM, _apply_layer, _dtype, _index
from repro_torch.serve.kv_slots import (init_slot_caches, read_slot,
                                        write_slot, zero_slot)
from repro_torch.serve.scheduler import (IDLE, IDLE_INJ, PREFILL, Injection,
                                         Request, SlotScheduler)
from repro_torch.tree import tree_map


SERVED_FAMILIES = ("dense", "ssm", "moe", "hybrid")


def check_servable(cfg: ModelConfig, chunk: int) -> None:
    """Raise for what the engine cannot serve: a family the port has not
    ported (encoder-decoder, VLM: NotImplementedError) and, for a config
    with Mamba-2 layers, a prefill ``chunk`` that is not a multiple of
    ``cfg.ssm.chunk_len`` (ValueError, the reference's assertion: the SSD
    scan's chunk grid must land on the same boundaries as the
    whole-prompt pass)."""
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: serving a {cfg.family!r} model is not ported yet "
            f"(the port serves {', '.join(SERVED_FAMILIES)})")
    if cfg.ssm is not None and chunk % cfg.ssm.chunk_len:
        raise ValueError(f"prefill chunk {chunk} must align with the SSD "
                         f"scan grid (cfg.ssm.chunk_len="
                         f"{cfg.ssm.chunk_len})")


def _paths(tree, pre=()):
    """Key paths of a nested dict's leaves."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, pre + (k,))
        else:
            yield pre + (k,)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def pack_blocks(lm: LM, params, layout: StageLayout, *,
                consume: bool = False) -> List:
    """LM parameters -> stage-stacked blocks: a list over period position
    ``jp`` of trees with leaves ``[P, M, ...]``, where ``blocks[jp]`` leaf
    ``[d, m]`` holds global layer ``layout.global_idx(d, 0, m * period +
    jp)``.  Padding layers (``g >= L``, gate 0) get zero parameters of the
    right structure.

    Where the layout allows (no padding and no remainder layers: the
    stage-major order is then the LM's stacking order), a block leaf is a
    view of the LM's stacked leaf, so the engine adds no second copy of
    the weights.  Otherwise (padding; or gemma3, whose local/global
    pattern stacks the LM by periods of 6 with 2 remainder layers while
    the layout's period is 1) each block leaf is built as a copy, one
    leaf at a time; with ``consume`` the caller hands ``params``' layer
    leaves over, and each is dropped from ``params["layers"]`` and
    ``["rem_layers"]`` once its rows are copied, so the peak is the
    weights plus one block leaf.  Either way engine and reference compute
    the identical network."""
    cfg = lm.cfg
    per, M = layout.period, layout.M
    assert layout.v == 1
    order = [[layout.global_idx(d, 0, mi * per + jp) for d in range(layout.P)
              for mi in range(M)] for jp in range(per)]
    if not lm.num_rem and lm.num_periods == layout.P * M and all(
            gs == [k * per + jp for k in range(lm.num_periods)]
            for jp, gs in enumerate(order)):
        return [tree_map(lambda a: a.view((layout.P, M) + a.shape[1:]),
                         params["layers"][jp]) for jp in range(per)]

    lper, nstk = lm.period, lm.num_periods * lm.period

    def source(g):
        """The LM tree holding layer ``g`` and its row there (None: an
        unstacked remainder layer)."""
        if g < nstk:
            return params["layers"][g % lper], g // lper
        return params["rem_layers"][g - nstk], None

    blocks = []
    for jp in range(per):
        real = [g for g in range(cfg.num_layers) if g % per == jp]
        assert real, f"no real layer shares period position {jp}"
        owners = {id(source(g)[0]): source(g)[0] for g in real}
        block: Dict = {}
        for path in list(_paths(source(real[0])[0])):
            def row(g):
                tree, i = source(g)
                leaf = _get(tree, path)
                return leaf if i is None else leaf[i]
            first = row(real[0])
            buf = torch.zeros((layout.P, M) + tuple(first.shape),
                              dtype=first.dtype, device=first.device)
            del first
            for d in range(layout.P):
                for mi in range(M):
                    g = layout.global_idx(d, 0, mi * per + jp)
                    if g < cfg.num_layers:
                        buf[d, mi].copy_(row(g))
            node = block
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = buf
            if consume:
                for tree in owners.values():
                    del _get(tree, path[:-1])[path[-1]]
        blocks.append(block)
    return blocks


def new_telemetry() -> Dict:
    """Serving telemetry: per-request wall-clock anchors, the
    delivered-token tally and the health monitor's non-CONTINUE actions
    as ``(tick, action)``.  :func:`~repro_torch.serve.resilience.
    serve_resilient` threads one through every engine incarnation, so
    TTFT and per-token latencies span recoveries."""
    return {"t_first": {}, "t_sub": {}, "tok_times": {}, "n_out": 0,
            "health_actions": []}


class PipelinedEngine:
    """Seq-chunked prefill + steady-tick decode over ``P`` virtual stages
    on one device.  ``lm_params`` is an ``LM.init`` (or bridged) tree on
    ``device``; it is packed into stage blocks here (views of its layer
    leaves where the layout allows, see :func:`pack_blocks`).  With
    ``consume_params`` the engine takes ownership of ``lm_params``' layer
    leaves: a copying pack drops each from the tree as it is packed, so
    the weights never sit on the card twice.  ``blocks`` hands over
    already stage-stacked blocks for this ``P`` (the elastic path,
    :meth:`rebuild_elastic`); ``lm_params`` then needs only ``embed`` and
    ``final_norm``."""

    def __init__(self, cfg: ModelConfig, lm_params, *, P: int, chunk: int,
                 max_seq: int, n_slots: Optional[int] = None,
                 kernels: str = "fused", device="cuda",
                 consume_params: bool = False, blocks=None):
        check_servable(cfg, chunk)
        self.cfg = cfg
        self.P = P
        self.chunk = chunk
        self.max_seq = max_seq
        self.n_slots = n_slots if n_slots is not None else P
        self.kernels = kernels
        self.device = resolve_device(device)
        self.lm = LM(cfg, kernels=kernels, device=self.device)
        self.layout = StageLayout.build(cfg, P, 1, Placement(P, 1))
        self.blocks = blocks if blocks is not None else pack_blocks(
            self.lm, lm_params, self.layout, consume=consume_params)
        per, M = self.layout.period, self.layout.M
        # parameter views per (stage, period-group, period position)
        self._stage_params = [[[_index(_index(self.blocks[jp], s), mi)
                                for jp in range(per)] for mi in range(M)]
                              for s in range(P)]
        self.shared = {"embed": lm_params["embed"],
                       "final_norm": lm_params["final_norm"]}
        fl = self.layout.flags(cfg)
        self.flags = {k: a[:, 0] for k, a in fl.items()}    # [P, M, per]
        self.caches = init_slot_caches(cfg, self.layout, self.n_slots,
                                       max_seq, self.device)
        self.wire = torch.zeros((P, chunk, cfg.d_model),
                                dtype=_dtype(cfg.compute_dtype),
                                device=self.device)
        self._hist: List[Injection] = []     # hist[k] = inj at tick t-k
        # over the engine's lifetime: stage executions by op, and sampled
        # waves whose logits were not all finite, by the scheduler's
        # verdict on their token (accepted / stale)
        self.stage_runs = {"prefill": 0, "decode": 0}
        self.nonfinite_logits = 0
        self.stale_nonfinite_logits = 0

    # -- one stage of one tick ---------------------------------------------
    def _run_stage(self, s: int, inj: Injection) -> torch.Tensor:
        """Run stage ``s``'s layers on wave ``inj``; returns [1, n, d] with
        n = chunk (prefill) or 1 (decode)."""
        cfg, dev = self.cfg, self.device
        n = self.chunk if inj.op == PREFILL else 1
        if s == 0:
            toks = torch.as_tensor(inj.tokens[:n], dtype=torch.int64,
                                   device=dev)
            x = self.lm.embed(self.shared, toks[None])
        else:
            x = self.wire[s, :n][None]
        caches_s = [{k: a[s] for k, a in t.items()} for t in self.caches]
        view = read_slot(caches_s, inj.slot)
        if inj.op == PREFILL and inj.first:
            # first chunk: clear the slot so the previous tenant's K/V,
            # conv tails and SSM state cannot leak (the slot then equals
            # a fresh single-host cache)
            zero_slot(view)
        positions = torch.arange(inj.pos, inj.pos + n, device=dev)[None]
        win, gate = self.flags["window"][s], self.flags["gate"][s]
        for mi in range(self.layout.M):
            for jp in range(self.layout.period):
                cache = {k: a[mi] for k, a in view[jp].items()}
                x, _, _ = _apply_layer(    # aux: a training term only
                    self._stage_params[s][mi][jp], x, positions, cfg, jp,
                    cache=cache, cache_pos=inj.pos,
                    window_override=int(win[mi, jp]),
                    gate=float(gate[mi, jp]), backend=self.lm.backend)
        write_slot(caches_s, view, inj.slot)
        self.stage_runs["prefill" if inj.op == PREFILL else "decode"] += 1
        return x

    def tick(self, inj: Injection):
        """Inject ``inj`` at stage 0 and advance every wave one stage.
        Returns ``(retired_injection, token, logits, finite)`` for the wave
        that just left the last stage (the injection from ``P - 1`` ticks
        ago).  The token is -1, the logits None and ``finite`` True unless
        that wave samples; then ``finite`` says whether its logits are all
        finite."""
        self._hist.insert(0, inj)
        token, logits, finite = -1, None, True
        for s in reversed(range(self.P)):
            inj_s = self._hist[s] if s < len(self._hist) else IDLE_INJ
            if inj_s.op == IDLE:
                continue
            x = self._run_stage(s, inj_s)
            if s + 1 < self.P:
                if inj_s.op == PREFILL:
                    self.wire[s + 1].copy_(x[0])
                else:      # decode: the next stage reads row 0 only
                    self.wire[s + 1, 0].copy_(x[0, 0])
            elif inj_s.sample:
                logits = self.lm.head(self.shared, x[:, -1:])[0, -1]
                tok = torch.argmax(logits)
                ok = torch.isfinite(logits).all()
                token, ok = torch.stack([tok, ok.long()]).tolist()
                finite = bool(ok)
        retired = self._hist.pop() if len(self._hist) == self.P \
            else IDLE_INJ
        return retired, token, logits, finite

    # -- fault surface ----------------------------------------------------
    def corrupt_slot(self, slot: int) -> None:
        """Scribble NaN over request slot ``slot``'s cache on every stage:
        the landing point of an injected
        :class:`~repro_torch.ft.inject.SlotCorruption` (every cache leaf
        is floating).  Recovery must re-prefill from the prompt: the first
        chunk's zeroing rebuilds the slot, so a missed re-admission
        surfaces as non-finite logits on accepted waves, not silence."""
        for t in self.caches:
            for a in t.values():
                a[:, :, slot] = float("nan")

    def rebuild_elastic(self, P_new: int) -> "PipelinedEngine":
        """This engine moved to ``P_new`` virtual stages after a device
        loss: the stage-stacked blocks re-index onto the new
        :class:`StageLayout` through
        :func:`~repro_torch.core.pipeline_runtime.remap_blocks_elastic`
        (no repack from the LM's parameters, which a consuming pack has
        dropped), with zero blocks where the new layout pads beyond the
        old one; the slot caches are built fresh (the requests' caches
        died with the stage; the scheduler re-admits them by re-prefill).
        Returns a new engine with the same kernels, device, chunk,
        max_seq and slots; the stages stay virtual, so there is no mesh."""
        assert P_new >= 1
        layout_new = StageLayout.build(self.cfg, P_new, 1,
                                       Placement(P_new, 1))
        # engine blocks are [P, M, ...] (v = 1); the elastic remap speaks
        # [P, v, M, ...]: insert and strip the unit v axis
        src = [tree_map(lambda a: a[:, None], t) for t in self.blocks]
        init = None
        if layout_new.L_pad > self.layout.L_pad:
            init = [tree_map(lambda a: torch.zeros(
                (P_new, 1, layout_new.M) + tuple(a.shape[2:]),
                dtype=a.dtype, device=a.device), t) for t in self.blocks]
        mig = remap_blocks_elastic(src, self.layout, layout_new,
                                   init_blocks=init)
        del src, init
        blocks = [tree_map(lambda a: a[:, 0], t) for t in mig]
        return PipelinedEngine(
            self.cfg, self.shared, P=P_new, chunk=self.chunk,
            max_seq=self.max_seq, n_slots=self.n_slots,
            kernels=self.kernels, device=self.device, blocks=blocks)

    # -- serving loop -----------------------------------------------------
    def serve(self, requests: List[Request], *,
              preempt_after: Optional[int] = None,
              clock: Optional[str] = "wall",
              max_ticks: int = 1_000_000,
              sched: Optional[SlotScheduler] = None,
              max_queue: Optional[int] = None, max_retries: int = 3,
              injector=None, watchdog=None, monitor=None,
              telemetry: Optional[Dict] = None,
              t0: Optional[float] = None) -> Dict:
        """Serve ``requests`` (arrivals ordered by ``arrival_s``) to
        terminal states with continuous batching; greedy decoding.

        ``clock="wall"`` admits arrivals by wall time (the benchmark
        mode; with nothing in flight the loop sleeps until the next
        arrival, where the reference ticks idle waves through its
        devices); ``clock=None`` admits everything immediately
        (deterministic, used by the equivalence tests).  Returns
        ``{"finished": {rid: FinishedRecord}, "metrics": {rid: {...}},
        "elapsed_s", "ticks", "tokens_per_s", "outcomes", "dropped",
        "counts", "occupied_slots", "health_actions", "first_sample_s",
        "stage_runs",
        "nonfinite_logits", "stale_nonfinite_logits"}`` with per-request
        TTFT / per-token wall-clock latencies.

        Resilience seams, all off by default (the decisions and streams
        are then those of the engine without them): ``sched`` /
        ``telemetry`` / ``t0`` let a caller own the scheduler state and
        the latency anchors across engine incarnations; ``injector`` (a
        :class:`~repro_torch.ft.inject.FaultInjector`) is driven through
        its tick seams, and a due device loss or hung tick raises
        :class:`~repro_torch.ft.inject.DeviceLossError` out of this method
        with ``pending`` (the requests not yet submitted), ``ticks_done``
        and ``first_sample_s`` attached; ``watchdog`` is armed around
        every tick; ``monitor`` (a
        :class:`~repro_torch.ft.health.HealthMonitor`) receives each
        tick's duration, straggler-inflated by the injector, and its
        non-CONTINUE actions go to ``telemetry["health_actions"]``.  With
        a monitor every tick ends in a device synchronize, so that its
        duration is the tick's device time and not its host dispatch;
        without one the synchronization is unchanged (a sampling wave
        only)."""
        if sched is None:
            sched = SlotScheduler(self.n_slots, self.chunk, self.max_seq,
                                  preempt_after=preempt_after,
                                  max_queue=max_queue,
                                  max_retries=max_retries)
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        tel = telemetry if telemetry is not None else new_telemetry()
        t_first, t_sub, tok_times = tel["t_first"], tel["t_sub"], \
            tel["tok_times"]
        t0 = time.perf_counter() if t0 is None else t0
        sync = monitor is not None and self.device.type == "cuda"
        ticks = 0
        first_sample_s = None
        try:
            while ticks < max_ticks:
                now = time.perf_counter() - t0
                dl_now = now if clock == "wall" else None
                while pending and (clock != "wall"
                                   or pending[0].arrival_s <= now):
                    req = pending.pop(0)
                    t_sub[req.rid] = max(req.arrival_s, now) \
                        if clock == "wall" else 0.0
                    sched.submit(req, now=dl_now)
                if pending and clock == "wall" and sched.idle and all(
                        h.op == IDLE for h in self._hist):
                    # nothing in flight: wait for the next arrival (an idle
                    # tick does no work here, and spinning them would run
                    # out max_ticks before a late arrival)
                    time.sleep(max(0.0, pending[0].arrival_s - now))
                    continue
                tick_no = sched.tick + 1
                if injector is not None:
                    injector.on_tick_start(tick_no)
                if watchdog is not None:
                    watchdog.arm()
                t_tick = time.perf_counter()
                inj = sched.next_injection(now=dl_now)
                retired, token, _, finite = self.tick(inj)
                if sync:
                    torch.cuda.synchronize(self.device)
                dt = time.perf_counter() - t_tick
                ticks += 1
                if injector is not None:
                    cslot = injector.take_slot_corruption(tick_no)
                    if cslot is not None:
                        self.corrupt_slot(cslot)
                        sched.fail_slot(cslot)
                    # the hung-tick seam runs while the watchdog is still
                    # armed (train_pipeline's on_step_end order)
                    injector.on_tick_end(tick_no, watchdog)
                if watchdog is not None:
                    if watchdog.check():
                        raise DeviceLossError(-1, "hung_tick", tick_no)
                    watchdog.disarm()
                if monitor is not None:
                    rep = injector.tick_time(tick_no, dt) \
                        if injector is not None else dt
                    act = monitor.record_step(rep)
                    if act != Action.CONTINUE:
                        tel["health_actions"].append((tick_no, act.value))
                if retired.sample and retired.op != IDLE:
                    if sched.on_result(retired, token):
                        self.nonfinite_logits += not finite
                        t = time.perf_counter() - t0
                        if first_sample_s is None:
                            first_sample_s = t
                        t_first.setdefault(retired.rid, t)
                        tok_times.setdefault(retired.rid, []).append(t)
                        tel["n_out"] += 1
                    else:
                        self.stale_nonfinite_logits += not finite
                if not pending and sched.idle and all(
                        h.op == IDLE for h in self._hist):
                    break
        except DeviceLossError as e:
            # hand the recovery loop everything it needs to resume
            e.pending = pending
            e.ticks_done = ticks
            e.first_sample_s = first_sample_s
            raise
        elapsed = time.perf_counter() - t0
        metrics = {}
        for rid, rec in sched.finished.items():
            ts = tok_times.get(rid, [])
            metrics[rid] = {
                "ttft_s": (t_first[rid] - t_sub.get(rid, 0.0))
                if rid in t_first else None,
                "per_token_s": [b - a for a, b in zip(ts, ts[1:])],
                "n_tokens": len(rec.tokens),
                "done_s": ts[-1] if ts else None,
            }
        return {"finished": sched.finished, "metrics": metrics,
                "elapsed_s": elapsed, "ticks": ticks,
                "tokens_per_s": tel["n_out"] / max(elapsed, 1e-9),
                "outcomes": dict(sched.outcomes),
                "dropped": dict(sched.dropped),
                "counts": sched.lifecycle_counts(),
                "occupied_slots": sorted(sched.active),
                "health_actions": list(tel["health_actions"]),
                "first_sample_s": first_sample_s,
                "stage_runs": dict(self.stage_runs),
                "nonfinite_logits": self.nonfinite_logits,
                "stale_nonfinite_logits": self.stale_nonfinite_logits}
