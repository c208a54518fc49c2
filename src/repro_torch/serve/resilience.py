"""Resilient serving: the elastic recovery loop around the pipelined
engine (port of ``repro/serve/resilience.py``).

The serving mirror of :func:`repro_torch.ft.elastic_pipeline.
train_elastic`: run :meth:`~repro_torch.serve.engine.PipelinedEngine.
serve` under a :class:`~repro_torch.ft.inject.FaultInjector`; when an
injected device loss (or a hung tick the watchdog converts into one)
surfaces as :class:`~repro_torch.ft.inject.DeviceLossError`, recover at
P-1 without dropping the service:

1. **detect**: the error's ``raised_at`` anchors the detection latency;
2. **re-plan**: solve the forward-only ``seq1f1b`` task table at the
   survivor depth (the validated-table discipline training uses);
3. **remap**: re-index the engine's stage-stacked blocks onto the new
   :class:`~repro_torch.core.layout.StageLayout` through
   :meth:`~repro_torch.serve.engine.PipelinedEngine.rebuild_elastic`
   (no repack from the LM's parameters);
4. **re-admit**: every in-flight request lost its slot cache with the
   failed stage; :meth:`~repro_torch.serve.scheduler.SlotScheduler.
   fail_all` requeues them at the front for re-prefill (greedy decoding
   regenerates the identical stream);
5. **resume**: the recovered incarnation's first delivered token closes
   the recovery record.

The scheduler, telemetry and wall-clock anchor are owned here and
threaded through every engine incarnation, so the per-request latencies
and the request lifecycle (terminal states, retry budgets, deadlines)
span recoveries.

**On one card the devices are the virtual stage slots**, as in
``train_elastic``: the pool starts as the ids ``0 .. P - 1``, a lost id
leaves it (``-1``, an unknown peer, drops the last), and each
incarnation serves on ``len(pool)`` virtual stages.  There is no mesh to
build and no device count to check.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.ft.health import HealthMonitor, Watchdog
from repro_torch.ft.inject import (DeviceLossError, FaultInjector, HungTick,
                                   SlotCorruption, StragglerTicks,
                                   TickDeviceLoss)

_FAULT_KINDS = {
    "device_loss": (TickDeviceLoss, {"tick": int, "device": int}),
    "slot_corruption": (SlotCorruption, {"tick": int, "slot": int}),
    "hung_tick": (HungTick, {"tick": int, "device": int,
                             "hang_s": float}),
    "straggler": (StragglerTicks, {"tick": int, "n_ticks": int,
                                   "factor": float}),
}


def parse_fault_spec(spec: str):
    """CLI fault syntax -> an injectable fault object.

    ``kind@key=val[,key=val...]``, e.g. ``device_loss@tick=40``,
    ``slot_corruption@tick=9,slot=1``, ``hung_tick@tick=7``,
    ``straggler@tick=5,n_ticks=4,factor=8``.  Raises ``ValueError`` with
    the valid vocabulary on a malformed spec."""
    kind, sep, rest = spec.partition("@")
    if kind not in _FAULT_KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r}; expected one of "
            f"{sorted(_FAULT_KINDS)} (syntax: kind@tick=N[,key=val])")
    cls, fields = _FAULT_KINDS[kind]
    kwargs = {}
    if sep:
        for item in filter(None, rest.split(",")):
            key, eq, val = item.partition("=")
            if not eq or key not in fields:
                raise ValueError(
                    f"bad fault arg {item!r} for {kind}; valid keys: "
                    f"{sorted(fields)}")
            try:
                kwargs[key] = fields[key](val)
            except ValueError:
                raise ValueError(
                    f"fault arg {key}={val!r} is not a valid "
                    f"{fields[key].__name__}")
    if "tick" not in kwargs:
        raise ValueError(f"fault spec {spec!r} must set tick=N")
    return cls(**kwargs)


@dataclass
class ServeRecovery:
    """Per-recovery phase timings (seconds)."""
    tick: int                   # serving tick the fault fired at
    kind: str                   # device_loss | hung_tick
    p_from: int
    p_to: int
    n_readmitted: int = 0       # in-flight requests requeued for
    #                             re-prefill
    detect_s: float = 0.0       # fault raise -> the loop caught it
    replan_s: float = 0.0       # forward-only table solve at P-1
    remap_s: float = 0.0        # rebuild_elastic (blocks remap, caches)
    readmit_s: float = 0.0      # fail_all + queue rebuild
    resume_s: float = 0.0       # restart -> first delivered token


def serve_resilient(cfg, lm_params, requests: Sequence, *, P: int,
                    chunk: int, max_seq: int,
                    n_slots: Optional[int] = None,
                    kernels: str = "fused", device="cuda", faults=(),
                    preempt_after: Optional[int] = None,
                    max_queue: Optional[int] = None,
                    max_retries: int = 3,
                    clock: Optional[str] = "wall",
                    watchdog_timeout: float = 60.0, min_P: int = 1,
                    max_incarnations: int = 4,
                    consume_params: bool = False,
                    log: Callable[[str], None] = print) -> Dict:
    """Serve ``requests`` to terminal states across device losses,
    re-planning the pipeline depth each incarnation.  ``faults`` is a
    list of faults or a :class:`FaultInjector`.  ``consume_params`` is
    handed to the first :class:`PipelinedEngine`: a copying pack then
    drops ``lm_params``' layer leaves as it packs them (every later
    incarnation is rebuilt from the engine's own blocks).

    Returns :meth:`PipelinedEngine.serve`'s result dict (finished
    records, metrics, lifecycle counts: all spanning recoveries, since
    one scheduler and one telemetry object thread through) with
    ``ticks`` (the scheduler's), ``recoveries`` (one
    :class:`ServeRecovery` per fault), ``incarnations`` (P, status,
    ticks, the stage ids, the engine's ``stage_runs``, the tokens it
    delivered and its wall seconds), the injector's
    fired-fault ``events``, and ``nonfinite_logits`` /
    ``stale_nonfinite_logits`` summed over the incarnations."""
    from repro_torch.core.tasktable import build_task_table
    from repro_torch.seqpipe.schedules import forward_only, seq1f1b
    from repro_torch.serve.engine import PipelinedEngine, new_telemetry
    from repro_torch.serve.scheduler import SlotScheduler

    injector = faults if isinstance(faults, FaultInjector) \
        else FaultInjector(faults)
    watchdog = Watchdog(watchdog_timeout, clock=injector.clock)
    monitor = HealthMonitor()
    n_slots = n_slots if n_slots is not None else P
    sched = SlotScheduler(n_slots, chunk, max_seq,
                          preempt_after=preempt_after,
                          max_queue=max_queue, max_retries=max_retries)
    tel = new_telemetry()
    healthy = list(range(P))
    n_seq = max(max(1, len(r.prompt) // chunk) for r in requests) \
        if requests else 1

    recoveries: List[ServeRecovery] = []
    incarnations: List[Dict] = []
    pending_rec: Optional[ServeRecovery] = None
    reqs = list(requests)
    nonfinite = [0, 0]
    eng = PipelinedEngine(cfg, lm_params, P=P, chunk=chunk,
                          max_seq=max_seq, n_slots=n_slots,
                          kernels=kernels, device=device,
                          consume_params=consume_params)
    t0 = time.perf_counter()
    out = None
    while len(incarnations) < max_incarnations:
        P_cur = eng.P
        log(f"[serve-ft] incarnation {len(incarnations)}: P={P_cur} over "
            f"stage slots {healthy}")
        t_run = time.perf_counter()
        n_out = tel["n_out"]
        fault = None
        try:
            out = eng.serve(reqs, clock=clock, sched=sched,
                            injector=injector, watchdog=watchdog,
                            monitor=monitor, telemetry=tel, t0=t0)
        except DeviceLossError as e:
            # keep the fields, not the error: its traceback holds the old
            # engine's frames, which must go before the new one serves
            fault = (time.time() - e.raised_at, e.kind, e.step, e.device,
                     list(getattr(e, "pending", [])),
                     getattr(e, "ticks_done", 0),
                     _resume_s(e, t0, t_run))
        nonfinite[0] += eng.nonfinite_logits
        nonfinite[1] += eng.stale_nonfinite_logits
        ran = {"stage_runs": dict(eng.stage_runs),
               "tokens": tel["n_out"] - n_out,
               "seconds": time.perf_counter() - t_run}
        if fault is None:
            incarnations.append({"P": P_cur, "status": "complete",
                                 "ticks": out["ticks"],
                                 "devices": list(healthy), **ran})
            if pending_rec is not None:
                pending_rec.resume_s = _resume_s(out, t0, t_run)
                recoveries.append(pending_rec)
                pending_rec = None
            break
        detect_s, kind, tick, dev, reqs, ticks_done, resumed = fault
        if pending_rec is not None:
            # the previous recovery did resume before this fault
            pending_rec.resume_s = resumed
            recoveries.append(pending_rec)
        lost = dev if dev in healthy else healthy[-1]
        healthy = [d for d in healthy if d != lost]
        P_new = len(healthy)
        log(f"[serve-ft] {kind} at tick {tick}: lost stage slot {lost}, "
            f"{P_new} left -> re-plan")
        incarnations.append({"P": P_cur, "status": kind,
                             "ticks": ticks_done,
                             "devices": healthy + [lost], **ran})
        if P_new < min_P:
            raise RuntimeError(
                f"unrecoverable: {P_new} stage slots left < min_P {min_P}")
        # re-plan: the forward-only seq1f1b table must solve at the
        # survivor depth (the validated-table gate training uses)
        t_p = time.perf_counter()
        if P_new > 1:
            build_task_table(forward_only(
                seq1f1b(P_new, max(n_slots, P_new), n_seq)))
        replan_s = time.perf_counter() - t_p
        # remap: the blocks re-indexed onto P_new stages, fresh caches;
        # the old engine is dropped as the new one takes its name
        t_m = time.perf_counter()
        eng = eng.rebuild_elastic(P_new)
        remap_s = time.perf_counter() - t_m
        # re-admit: in-flight requests lost their caches with the stage;
        # requeue them at the front for re-prefill
        t_a = time.perf_counter()
        victims = sched.fail_all("device_loss")
        readmit_s = time.perf_counter() - t_a
        log(f"[serve-ft] re-admitted {len(victims)} in-flight requests "
            f"for re-prefill: {victims}")
        pending_rec = ServeRecovery(
            tick=tick if tick is not None else -1, kind=kind,
            p_from=P_cur, p_to=P_new, n_readmitted=len(victims),
            detect_s=detect_s, replan_s=replan_s, remap_s=remap_s,
            readmit_s=readmit_s)
    else:
        raise RuntimeError(
            f"serve did not complete within {max_incarnations} "
            "incarnations")
    return dict(out, ticks=sched.tick, recoveries=recoveries,
                incarnations=incarnations, events=injector.events,
                nonfinite_logits=nonfinite[0],
                stale_nonfinite_logits=nonfinite[1])


def _resume_s(src, t0: float, t_run: float) -> float:
    """Restart -> first token delivered by the recovered incarnation
    (``src`` is the serve() result or the next DeviceLossError)."""
    first = src["first_sample_s"] if isinstance(src, dict) \
        else getattr(src, "first_sample_s", None)
    if first is not None:
        return t0 + first - t_run
    return time.perf_counter() - t_run
