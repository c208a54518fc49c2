"""End-to-end elastic recovery for the pipeline driver (port of
``repro/ft/elastic_pipeline.py``).

The recovery loop of the paper's long-pretraining setting: a pipeline
stage dies at step k, the health check fires, the pipeline re-plans at
P-1 over the survivors, the topology-independent checkpoint restores,
and — because the checkpoint's stacked block leaves were laid out for
the *old* ``StageLayout`` — the parameters and optimizer moments
live-migrate onto the new placement through
:func:`repro_torch.core.pipeline_runtime.remap_blocks_elastic` before
training resumes.  When the device returns, the same machinery scales
back up to P.

**On one card the "devices" are the virtual stage slots.** The port's
executor runs ``P`` virtual stages in lockstep on one device, so
``n_devices`` (required) is the starting P and the pool is the ids
``0 .. n_devices - 1``: a lost id leaves the pool, ``plan_mesh(...,
min_pp=1)`` re-plans P over the ids left, and each incarnation is
``train_pipeline(tc, P=P, device=device)``.  There is no mesh to build
and no device list to check; device loss is what the fault injector
(or a watchdog trip) raises.

Step-count exactness: the microbatch decomposition is pinned
(``plan.num_microbatches``) so every incarnation computes the same
global batch per step, the data cursor checkpoints exactly (the
prefetcher snapshots the source state per consumed batch), and every
incarnation restores from a checkpoint (``train_pipeline`` saves step 0
before its first step), so the resumed run's per-step losses follow an
uninterrupted run's; only the summation order of the gradient norm over
leaves of other shapes separates them.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import TrainConfig
from repro_torch.ft.checkpoint import Checkpointer
from repro_torch.ft.elastic import MeshRequirements, plan_mesh
from repro_torch.ft.health import Watchdog
from repro_torch.ft.inject import DeviceLossError, FaultInjector


@dataclass
class RecoveryRecord:
    """Per-recovery phase timings (seconds)."""
    step: int                   # first step of the new incarnation
    kind: str                   # device_loss | hung_collective |
    #                             straggler_restart | scale_up
    p_from: int
    p_to: int
    detect_s: float = 0.0       # fault raise -> driver caught it
    replan_s: float = 0.0       # plan_mesh + new layout/schedule solve
    restore_s: float = 0.0      # checkpoint read (migration path)
    remap_s: float = 0.0        # remap_blocks_elastic + durable re-save
    resume_s: float = 0.0       # restart -> first completed step


def _build_layout(tc: TrainConfig, P: int):
    """The ``StageLayout`` train_pipeline will run under at depth P
    (validated spec construction, so migration and execution agree)."""
    from repro_torch.core.pipeline_runtime import make_pipeline_spec
    from repro_torch.launch.steps import plan_schedule_kwargs
    plan, shape = tc.plan, tc.shape
    mbB = plan.microbatch_size
    m = plan.num_microbatches or max(2, shape.global_batch // mbB)
    spec = make_pipeline_spec(
        tc.model, P=P, v=plan.num_chunks, m=m, microbatch=mbB,
        seq_len=shape.seq_len, schedule=plan.schedule,
        n_seq=plan.seq_chunks, kernels=plan.kernels,
        **plan_schedule_kwargs(plan))
    return spec.layout


def migrate_checkpoint(ck: Checkpointer, tc: TrainConfig, layout_new, *,
                       device="cuda", log: Callable[[str], None] = print):
    """Live-migrate the latest checkpoint onto ``layout_new``.

    Restores on ``device`` under the layout recorded in the checkpoint's
    ``extra`` (each leaf comes back with its stored shape), remaps the
    stacked parameter blocks and the optimizer's mu / nu / master blocks
    position for position onto the new (P, v, placement), and durably
    re-saves at the same step with the new layout metadata.  Padding
    positions the old span never held are filled from a fresh init
    (``init_pipeline_params`` from ``tc.seed``; the master its fp32 copy)
    and zero moments.

    Returns ``(restore_s, remap_s)``; ``(0, 0)`` when no checkpoint
    exists or the layout already matches."""
    from repro_torch.core.layout import StageLayout
    from repro_torch.core.pipeline_runtime import (init_pipeline_params,
                                                   remap_blocks_elastic)
    from repro_torch.core.placement import get_placement
    from repro_torch.optim import adamw_init
    latest = ck.latest_step()
    if latest is None:
        return 0.0, 0.0
    meta = ck.read_extra(latest).get("layout")
    if meta is None:
        raise RuntimeError(
            f"checkpoint step {latest} carries no layout metadata; "
            "cannot migrate (was it written by train_pipeline?)")
    if (meta["P"], meta["v"], meta["placement"]) == (
            layout_new.P, layout_new.v, layout_new.pl.name):
        return 0.0, 0.0
    assert not tc.plan.offload.enabled, \
        "elastic migration of host-offloaded optimizer state is not " \
        "implemented (device checkpoints carry no host momenta)"
    dev = resolve_device(device)
    t0 = time.time()
    # a fresh init under the new layout: the restore's template (the
    # tree's structure is the same at every P; each leaf comes back with
    # the checkpoint's shape) and the padding positions' source
    gen = torch.Generator(device=dev).manual_seed(tc.seed)
    params_new = init_pipeline_params(gen, tc.model, layout_new, dev)
    opt_new0 = adamw_init(params_new)
    restored, extra = ck.restore({"params": params_new, "opt": opt_new0})
    restore_s = time.time() - t0

    t0 = time.time()
    layout_old = StageLayout.build(
        tc.model, meta["P"], meta["v"],
        get_placement(meta["placement"], meta["P"], meta["v"]))
    p_r, o_r = restored["params"], restored["opt"]
    params_mig = {**p_r, "blocks": remap_blocks_elastic(
        p_r["blocks"], layout_old, layout_new,
        init_blocks=params_new["blocks"])}
    opt_mig = dict(o_r)
    for k in ("mu", "nu", "master"):
        opt_mig[k] = {**o_r[k], "blocks": remap_blocks_elastic(
            o_r[k]["blocks"], layout_old, layout_new,
            init_blocks=opt_new0[k]["blocks"])}
    del restored, p_r, o_r, params_new, opt_new0
    extra = dict(extra, layout={
        "P": layout_new.P, "v": layout_new.v,
        "schedule": tc.plan.schedule, "placement": layout_new.pl.name})
    ck.save(latest, {"params": params_mig, "opt": opt_mig}, extra=extra)
    remap_s = time.time() - t0
    log(f"[elastic] migrated checkpoint step {latest}: "
        f"P={meta['P']} v={meta['v']} ({meta['placement']}) -> "
        f"P={layout_new.P} v={layout_new.v} ({layout_new.pl.name}) "
        f"restore {restore_s * 1e3:.0f}ms remap {remap_s * 1e3:.0f}ms")
    return restore_s, remap_s


def train_elastic(tc: TrainConfig, *, n_devices: int, faults=(),
                  steps: Optional[int] = None, data_source=None,
                  watchdog_timeout: float = 600.0,
                  max_incarnations: int = 8, device="cuda",
                  log: Callable[[str], None] = print) -> Dict:
    """Elastic pipeline training: run to ``steps`` across device loss
    and return, re-planning the pipeline depth each incarnation.

    ``n_devices`` virtual stages to start with (the module docstring);
    ``tc.checkpoint_dir`` must be set.  On a :class:`DeviceLossError`
    the failed id leaves the pool, ``plan_mesh`` (with ``min_pp=1``)
    re-solves the depth over the ids left, the checkpoint migrates onto
    the new ``StageLayout``, and training resumes from the last durable
    step.  A :class:`~repro_torch.ft.inject.DeviceJoin` (or any preempted
    yield) returns lost ids and scales back up the same way.

    Returns the merged per-step losses (``loss_by_step``, ``losses``),
    ``final_loss``, ``steps``, the per-recovery phase timings
    (``recoveries``), the incarnation log (``incarnations``: P, status,
    the ids, and the steps completed with their ``step_s``) and the
    injector's ``events``, as the reference does; plus the last
    incarnation's ``params`` and ``opt_state`` and every save's and
    restore's record (``checkpoint_records``, in order)."""
    from repro_torch.launch.train import train_pipeline
    if tc.checkpoint_dir is None:
        raise ValueError("train_elastic needs tc.checkpoint_dir")
    steps = steps or tc.optimizer.total_steps
    plan = tc.plan
    if not plan.num_microbatches:
        # pin m now: every incarnation must keep the same microbatch
        # decomposition for step-count-exact trajectories
        plan = dataclasses.replace(plan, num_microbatches=max(
            2, tc.shape.global_batch // plan.microbatch_size))
    tc = dataclasses.replace(tc, plan=plan)
    req = MeshRequirements(tp_divides=1,
                           global_batch=tc.shape.global_batch,
                           pp=n_devices, min_pp=1)
    injector = faults if isinstance(faults, FaultInjector) \
        else FaultInjector(faults)
    ck = Checkpointer(tc.checkpoint_dir, keep=tc.keep_checkpoints)

    healthy = list(range(n_devices))
    loss_by_step: Dict[int, float] = {}
    recoveries: List[RecoveryRecord] = []
    incarnations: List[Dict] = []
    records: List[Dict] = []
    pending: Optional[RecoveryRecord] = None
    out = None

    def close(rec, P, replan_s, restore_s, remap_s, resume_s):
        rec.p_to, rec.replan_s = P, replan_s
        rec.restore_s, rec.remap_s, rec.resume_s = restore_s, remap_s, \
            resume_s
        recoveries.append(rec)

    while len(incarnations) < max_incarnations:
        t0 = time.time()
        decision = plan_mesh(len(healthy), req)
        assert decision is not None and decision.pp >= 1, \
            f"no feasible pipeline over {len(healthy)} stage slots"
        P = decision.pp
        layout = _build_layout(tc, P)
        replan_s = time.time() - t0
        n_rec = len(ck.records)
        restore_s, remap_s = migrate_checkpoint(ck, tc, layout,
                                                device=device, log=log)
        records += ck.records[n_rec:]
        watchdog = Watchdog(watchdog_timeout, clock=injector.clock)
        log(f"[elastic] incarnation {len(incarnations)}: P={P} over "
            f"stage slots {healthy[:P]}")
        t_run = time.time()
        try:
            out = train_pipeline(tc, P=P, device=device, steps=steps,
                                 data_source=data_source,
                                 injector=injector, watchdog=watchdog,
                                 log=log)
        except DeviceLossError as e:
            detect_s = time.time() - e.raised_at
            made_steps = getattr(e, "loss_by_step", {})
            loss_by_step.update(made_steps)
            records += getattr(e, "checkpoint_records", [])
            if pending is not None and made_steps:
                # the previous recovery *did* resume (this incarnation
                # completed steps before dying of a later fault) —
                # close its record before opening the new one
                close(pending, P, replan_s, restore_s, remap_s,
                      getattr(e, "first_step_s", None)
                      or (time.time() - t_run))
            # fault ids are pool ids (matching DeviceJoin); -1 =
            # "unknown peer" from a watchdog trip
            lost = e.device if e.device in healthy else healthy[-1]
            healthy = [d for d in healthy if d != lost]
            log(f"[elastic] {e.kind} at step {e.step}: lost stage slot "
                f"{lost}, {len(healthy)} left -> re-plan")
            incarnations.append({"P": P, "status": e.kind,
                                 "steps": len(made_steps),
                                 "step_s": getattr(e, "step_s", []),
                                 "devices": healthy + [lost]})
            pending = RecoveryRecord(
                step=e.step if e.step is not None else -1, kind=e.kind,
                p_from=P, p_to=-1, detect_s=detect_s)
            continue
        loss_by_step.update(out["loss_by_step"])
        records += out["checkpoint_records"]
        incarnations.append({"P": P, "status": out["status"],
                             "steps": out["steps"], "step_s": out["step_s"],
                             "devices": list(healthy[:P])})
        if pending is not None:
            # the incarnation that *recovered* closes the record
            close(pending, P, replan_s, restore_s, remap_s,
                  out["first_step_s"] or (time.time() - t_run))
            pending = None
        if out["status"] == "complete":
            break
        if out["status"] == "preempted":
            rejoined = [d for d in injector.take_rejoined()
                        if d not in healthy]
            healthy = sorted(healthy + rejoined)
            log(f"[elastic] stage slots {rejoined} rejoined -> warm "
                f"scale-up over {len(healthy)}")
            pending = RecoveryRecord(step=out["next_step"],
                                     kind="scale_up", p_from=P, p_to=-1)
        elif out["status"] == "restart":
            log("[elastic] straggler restart (same pool)")
            pending = RecoveryRecord(step=out["next_step"],
                                     kind="straggler_restart",
                                     p_from=P, p_to=-1)
    else:
        raise RuntimeError(
            f"elastic run did not complete within {max_incarnations} "
            "incarnations")
    return {"loss_by_step": loss_by_step,
            "losses": [loss_by_step[s] for s in sorted(loss_by_step)],
            "final_loss": out["final_loss"],
            "steps": steps, "recoveries": recoveries,
            "incarnations": incarnations, "events": injector.events,
            "params": out["params"], "opt_state": out["opt_state"],
            "checkpoint_records": records}
