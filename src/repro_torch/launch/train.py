"""Training entry points of the port, each on one device, with the
reference's checkpointer, health monitor, fault injector and watchdog
(``repro_torch.ft``):

- :func:`train`: the single-device driver (``train`` of
  ``repro/launch/train.py``): every microbatch's loss through
  ``LM.loss`` under Chronos-Recomp, gradients summed in fp32, then AdamW;
- :func:`train_pipeline`: ChronosPipe pipeline training under any
  generator of the schedule registry (the V-shape family with its
  fold-back placement; the sequence-chunked family with
  ``plan.seq_chunks`` chunks per microbatch), with Chronos-Offload (the
  deepest chunks' AdamW on the host) when ``plan.offload.enabled``, and
  the fault seams the elastic driver
  (:func:`repro_torch.ft.elastic_pipeline.train_elastic`) drives.

    from repro_torch.launch.train import train, train_pipeline
    out = train(tc)                                # on the card
    out = train(tc, device="cpu")                  # plain versions
    out = train_pipeline(tc, P=4)                  # on the card
    out = train_pipeline(tc, P=2, device="cpu")    # plain versions

``P`` virtual stages run in lockstep on the device (the reference maps
them onto a mesh axis).  Both run on CUDA unless ``device="cpu"``; a CUDA
request without a card raises.

Checkpoints (``tc.checkpoint_dir``): both drivers restore the latest
checkpoint of the directory at start (parameters, optimizer state, the
data cursor and the step to resume at), save every
``tc.checkpoint_every`` steps and when the health monitor asks for a
snapshot (asynchronously: the copy to host memory ends before the next
step), stop when it sees a persistent straggler, and save synchronously
at the step actually reached, keeping ``tc.keep_checkpoints`` steps, in
the reference's on-disk format (:mod:`repro_torch.ft.checkpoint`).  The
port's default ``checkpoint_dir`` is None, where the reference's is
``"/tmp/repro_ckpt"``: without a directory nothing is saved or restored,
and the monitor's snapshot and restart actions are off (there would be
nothing to restart from).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import TrainConfig
from repro_torch.core.pipeline_runtime import init_pipeline_params
from repro_torch.data import DataPipeline, synthetic_source
from repro_torch.ft.checkpoint import Checkpointer
from repro_torch.ft.health import Action, HealthMonitor
from repro_torch.ft.inject import DeviceLossError
from repro_torch.launch.steps import (make_pipeline_train_step,
                                      make_train_step, offload_kept)
from repro_torch.optim import adamw_init
from repro_torch.optim.offload import (ChronosOffloadRunner,
                                       merge_deep_shallow)


def _checkpointer(tc: TrainConfig) -> Optional[Checkpointer]:
    return Checkpointer(tc.checkpoint_dir, keep=tc.keep_checkpoints) \
        if tc.checkpoint_dir is not None else None


def _wants_save(ck, tc: TrainConfig, step: int, action: Action) -> bool:
    """The reference's rule: a snapshot the monitor asked for, or a
    periodic one (never at step 0)."""
    return ck is not None and (action == Action.CHECKPOINT_NOW or (
        step and step % tc.checkpoint_every == 0))


def _resume(ck, pipe, tree, log, tag, layout=None) -> Optional[int]:
    """Restore the latest checkpoint of ``ck`` into ``tree`` (``params``
    and ``opt``, in place) and the data cursor into ``pipe``; return the
    step to resume at, or None when there is nothing to restore.  With
    ``layout`` (the pipeline's P, v, schedule and placement), a
    checkpoint written under another (P, v, placement) raises: its block
    leaves would land at the wrong (device, chunk) positions."""
    latest = ck.latest_step() if ck is not None else None
    if latest is None:
        return None
    meta = ck.read_extra(latest).get("layout")
    key = ("P", "v", "placement")
    if layout is not None and meta is not None and \
            tuple(meta[k] for k in key) != tuple(layout[k] for k in key):
        raise RuntimeError(
            f"checkpoint step {latest} was written under layout "
            f"P={meta['P']} v={meta['v']} ({meta['placement']}) but this "
            f"run uses P={layout['P']} v={layout['v']} "
            f"({layout['placement']}); migrate it first "
            "(repro_torch.ft.elastic_pipeline.migrate_checkpoint)")
    extra = ck.restore_into(tree)
    if "data" in extra:
        pipe.load_state(extra["data"])
    start = int(extra.get("step", latest))
    log(f"[{tag}] restored checkpoint step {start}")
    return start


def _save(ck, pipe, save_step, next_step, params, opt_state, *, sync,
          log, tag, layout=None, injector=None):
    """Checkpoint ``params`` and ``opt`` with the step to resume at, the
    data cursor and (pipeline runs) the layout in ``extra``; a write
    that dies (a fault ``injector`` arms the crash) is retried
    synchronously, so LATEST keeps resolving to a complete step."""
    if injector is not None:
        injector.arm_checkpoint_crash(save_step)
    tree = {"params": params, "opt": opt_state}
    extra = {"step": next_step, "data": pipe.state()}
    if layout is not None:
        extra["layout"] = layout
    try:
        (ck.save if sync else ck.save_async)(save_step, tree, extra=extra)
    except Exception as e:                   # noqa: BLE001
        log(f"[{tag}] checkpoint write died ({e!r}) -> synchronous retry")
        ck.save(save_step, tree, extra=extra)


def train(tc: TrainConfig, *, device="cuda", steps: Optional[int] = None,
          data_source=None, params=None,
          log: Callable[[str], None] = print) -> Dict:
    """Single-device training: ``steps`` (default
    ``tc.optimizer.total_steps``) steps of ``m = global_batch //
    microbatch_size`` microbatches each, through
    :func:`repro_torch.launch.steps.make_train_step`: every microbatch's
    ``LM.loss`` under the Chronos-Recomp checkpoints of
    ``plan.recompute`` over ``plan.num_chunks`` chunks, its gradient
    added into fp32 buffers, then AdamW on their sum divided by ``m``.
    Every key of a batch (``tokens``, and a ``loss_mask`` where the data
    source gives one) reaches ``LM.loss``.

    Parameters are drawn from a ``torch.Generator`` seeded with
    ``tc.seed`` unless ``params`` (an ``LM`` tree on ``device``, e.g.
    bridged weights) is given; either tree is updated in place at every
    step (the fp32 masters are written into it).  The data come from
    ``data_source`` or ``synthetic_source(cfg, seed=tc.seed)`` (tokens,
    and a VLM's patch or an encoder's frame embeddings) through the
    prefetching :class:`DataPipeline`.

    With ``tc.checkpoint_dir`` set, the reference's checkpoint path (the
    module docstring): the latest checkpoint of the directory (one the
    reference's ``train()`` wrote too) is copied into the tree in place
    and the run goes on from its step; steps ``start .. steps - 1`` run.
    The update is the plain AdamW, as the reference's ``train()`` runs
    it: the fused-AdamW kernel runs only inside the pipeline executor.

    Returns ``losses`` (the steps this call ran), ``final_loss``,
    ``steps``, ``wall_s`` and ``median_step_s`` (the health monitor's) as
    the reference does, plus ``start_step``, per-step ``grad_norms``,
    ``lrs`` and ``step_s``, the final ``params`` and ``opt_state``, and
    ``checkpoint_records`` (:attr:`Checkpointer.records`)."""
    cfg, shape, plan, ocfg = tc.model, tc.shape, tc.plan, tc.optimizer
    dev = resolve_device(device)
    steps = steps or ocfg.total_steps
    mbB = plan.microbatch_size
    m = max(1, shape.global_batch // mbB)
    step_fn, lm = make_train_step(cfg, plan, ocfg, m, device=dev)
    if params is None:
        params = lm.init(torch.Generator(device=dev).manual_seed(tc.seed))
    opt_state = adamw_init(params)

    source = data_source or synthetic_source(cfg, shape.seq_len,
                                             seed=tc.seed)
    pipe = DataPipeline(source, global_batch=mbB * m, microbatches=m,
                        prefetch=2)
    ck = _checkpointer(tc)
    monitor = HealthMonitor()
    start_step = _resume(ck, pipe, {"params": params, "opt": opt_state},
                         log, "train") or 0

    def save(save_step, next_step_, sync):
        _save(ck, pipe, save_step, next_step_, params, opt_state,
              sync=sync, log=log, tag="train")

    pipe.start()
    losses, gnorms, lrs, step_s = [], [], [], []
    next_step = start_step
    t_start = time.time()
    try:
        for step in range(start_step, steps):
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.next().items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])     # waits for the step
            dt = time.time() - t0
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            lrs.append(float(metrics["lr"]))
            step_s.append(dt)
            next_step = step + 1
            action = monitor.record_step(dt)
            if step % tc.log_every == 0:
                log(f"[train] step {step} loss {loss:.4f} "
                    f"gnorm {gnorms[-1]:.3f} lr {lrs[-1]:.3e} ({dt:.2f}s)")
            if _wants_save(ck, tc, step, action):
                save(step, step + 1, sync=False)
            if ck is not None and action == Action.RESTART:
                log("[train] persistent straggler detected -> checkpoint "
                    "+ abort for elastic restart")
                break
        if ck is not None:
            # final save at the step actually reached (an early RESTART
            # abort must not mislabel the checkpoint as having finished)
            save(next_step, next_step, sync=True)
    finally:
        pipe.stop()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "steps": len(losses), "wall_s": time.time() - t_start,
            "median_step_s": monitor.median_step, "start_step": start_step,
            "grad_norms": gnorms, "lrs": lrs, "step_s": step_s,
            "params": params, "opt_state": opt_state,
            "checkpoint_records": ck.records if ck is not None else []}


def train_pipeline(tc: TrainConfig, *, P: int, device="cuda",
                   steps: Optional[int] = None, data_source=None,
                   params=None, injector=None, watchdog=None,
                   log: Callable[[str], None] = print) -> Dict:
    """Train up to ``steps`` (default ``tc.optimizer.total_steps``) steps.
    Parameters are drawn from a ``torch.Generator`` seeded with
    ``tc.seed`` unless ``params`` (a stage-stacked tree on ``device``,
    e.g. bridged weights) is given; either tree is updated in place at
    every step (the fp32 masters are written into it).  The data
    come from ``data_source`` or ``synthetic_source(cfg, seed=tc.seed)``
    (tokens, and a VLM's patch or an encoder's frame embeddings) through
    the prefetching :class:`DataPipeline`; every key of a batch reaches
    the step, a source's ``loss_mask`` (aligned with the tokens, as
    ``LM.loss`` reads it) cut to the label positions (``[..., 1:]``).

    ``plan.schedule`` names any registered generator; the plan's
    ``seq_chunks`` reaches the sequence-chunked ones, and the reference's
    refusals raise ValueError (a V-shape schedule with ``num_chunks !=
    2``, ``seq_chunks > 1`` with another schedule or on a model with SSM
    layers, a sequence length that does not split into the chunks).

    Chronos-Offload (``tc.plan.offload.enabled``), in the reference's
    order: a :class:`ChronosOffloadRunner` over the deep chunks' views of
    ``params``; each step's deep gradients are submitted before the loss
    is read, and the host update is collected (its bf16 weights uploaded
    in place) after the next batch is fetched and before the next step,
    timed into ``collect_wait_s``; a last collect follows the loop.

    Checkpoints and fault seams (``tc.checkpoint_dir`` set; the
    reference's driver):

    - every checkpoint records the layout (P, v, schedule, placement) in
      its ``extra``; restoring one written under another (P, v,
      placement) raises RuntimeError (migrate it first:
      :func:`repro_torch.ft.elastic_pipeline.migrate_checkpoint`);
    - a run that finds no checkpoint saves step 0 synchronously first:
      the stage-stacked init draws positions in order from one
      generator, so a fresh init at another P is another network, and a
      recovery is exact only because every incarnation restores;
    - a checkpoint write that dies is retried synchronously; a write
      still in flight when the run dies is waited for (its failure
      logged: the previous checkpoint stands);
    - ``injector`` (:class:`repro_torch.ft.inject.FaultInjector`): a due
      :class:`~repro_torch.ft.inject.DeviceJoin` saves and returns with
      status ``"preempted"``; device loss raises from ``on_step_start``
      before the step runs; its ``step_time`` is what the health monitor
      reads; a monitor RESTART returns status ``"restart"``;
    - ``watchdog`` (:class:`repro_torch.ft.health.Watchdog`) is armed
      around each step and checked after it: a trip raises
      ``DeviceLossError(-1, "hung_collective", step)``.  A
      :class:`~repro_torch.ft.inject.DeviceLossError` leaving the loop
      carries ``loss_by_step``, ``next_step``, ``first_step_s``,
      ``step_s`` and ``checkpoint_records`` of the steps completed;
    - under offload the pending host update is folded in before any
      checkpoint, and after a restore the host optimizer is built from
      the restored weights (host momenta are not checkpointed, as in the
      reference).

    Returns ``losses``, ``loss_by_step``, ``final_loss``, ``steps``,
    ``start_step``, ``next_step``, ``status`` (``"complete"``,
    ``"restart"`` or ``"preempted"``), ``first_step_s`` (the resume
    cost), ``wall_s``, ``median_step_s`` (the health monitor's) and
    ``schedule`` as the reference does, plus per-step ``grad_norms``,
    ``lrs`` and ``step_s``, the final ``params`` and ``opt_state`` and
    ``checkpoint_records``; under offload also ``offload``
    (:func:`offload_report`) and ``host_optimizer`` (the runner's
    :class:`~repro_torch.optim.offload.HostAdamW`, its numpy state)."""
    cfg, shape, plan, ocfg = tc.model, tc.shape, tc.plan, tc.optimizer
    dev = resolve_device(device)
    steps = steps or ocfg.total_steps
    step_fn, m, mbB, spec = make_pipeline_train_step(cfg, shape, plan,
                                                     ocfg, P=P, device=dev)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(tc.seed)
        params = init_pipeline_params(gen, cfg, spec.layout, dev)
    offload = plan.offload.enabled and plan.offload.num_offload_chunks > 0
    if offload:
        kept, deep = offload_kept(params, plan)
        opt_state = adamw_init(kept)
    else:
        opt_state = adamw_init(params)

    source = data_source or synthetic_source(cfg, shape.seq_len,
                                             seed=tc.seed)
    pipe = DataPipeline(source, global_batch=mbB * m, microbatches=m,
                        prefetch=2)
    ck = _checkpointer(tc)
    monitor = HealthMonitor()
    layout_meta = {"P": spec.table.P, "v": plan.num_chunks,
                   "schedule": plan.schedule,
                   "placement": spec.layout.pl.name}
    resumed = _resume(ck, pipe, {"params": params, "opt": opt_state}, log,
                      "train-pp", layout=layout_meta)
    start_step = resumed or 0
    # built after the restore: the host masters start from the restored
    # deep weights
    runner = ChronosOffloadRunner(deep, ocfg) if offload else None

    def fold_pending():
        merge_deep_shallow(kept["blocks"], runner.collect(),
                           out=params["blocks"])

    def save_ckpt(save_step, next_step_, *, sync=False):
        _save(ck, pipe, save_step, next_step_, params, opt_state,
              sync=sync, log=log, tag="train-pp", layout=layout_meta,
              injector=injector)

    pipe.start()
    if ck is not None and resumed is None:
        save_ckpt(0, 0, sync=True)           # the durable step-0 snapshot
    losses, gnorms, lrs, step_s = [], [], [], []
    loss_by_step: Dict[int, float] = {}
    status, next_step, first_step_s = "complete", start_step, None
    pending, collect_wait_s = False, 0.0
    t_start = time.time()
    try:
        for step in range(start_step, steps):
            if injector is not None and injector.should_yield(step):
                # a lost device rejoined: publish a clean checkpoint and
                # hand control back for the warm scale-up restart
                if pending:
                    fold_pending()
                    pending = False
                if ck is not None:
                    save_ckpt(step, step, sync=True)
                status = "preempted"
                break
            if injector is not None:
                injector.on_step_start(step)
            t0 = time.time()
            batch = {k: torch.from_numpy(a).to(dev)
                     for k, a in pipe.next().items()}
            if "loss_mask" in batch:
                batch["loss_mask"] = batch["loss_mask"][..., 1:]
            if pending:
                t_c = time.time()
                fold_pending()            # bf16 upload of the deep chunks
                pending = False
                collect_wait_s += time.time() - t_c
            if watchdog is not None:
                watchdog.arm()
            out = step_fn(params, opt_state, batch)
            params, opt_state, metrics = out[:3]
            if offload:
                runner.submit(out[3], grad_div=m)   # grads down, host AdamW
                pending = True
            # the deep gradients are views of the step's accumulators:
            # held here, they would live through the next step
            del out
            loss = float(metrics["loss"])     # waits for the step
            if injector is not None:
                injector.on_step_end(step, watchdog)
            if watchdog is not None:
                if watchdog.check():
                    raise DeviceLossError(-1, "hung_collective", step)
                watchdog.disarm()
            dt = time.time() - t0
            losses.append(loss)
            loss_by_step[step] = loss
            gnorms.append(float(metrics["grad_norm"]))
            lrs.append(float(metrics["lr"]))
            step_s.append(dt)
            next_step = step + 1
            if first_step_s is None:
                first_step_s = time.time() - t_start
            action = monitor.record_step(
                injector.step_time(step, dt) if injector is not None
                else dt)
            if step % tc.log_every == 0:
                log(f"[train-pp] step {step} loss {loss:.4f} "
                    f"gnorm {gnorms[-1]:.3f} lr {lrs[-1]:.3e} ({dt:.2f}s)")
            if _wants_save(ck, tc, step, action):
                if pending:
                    # fold the in-flight host update in first: otherwise
                    # the checkpoint's deep chunks are one step stale
                    fold_pending()
                    pending = False
                save_ckpt(step, step + 1)
            if ck is not None and action == Action.RESTART:
                log("[train-pp] persistent straggler -> checkpoint + "
                    "abort")
                status = "restart"
                break
        if pending:
            fold_pending()
        if ck is not None and status != "preempted":
            # final save at the step actually reached (a RESTART abort
            # must not mislabel the checkpoint as having finished)
            save_ckpt(next_step, next_step, sync=True)
    except BaseException as e:
        # the incarnation dies: let a write in flight end (the elastic
        # driver reads the directory next), and hand the completed
        # steps to the elastic driver on the error
        if ck is not None:
            try:
                ck.wait()
            except Exception as werr:         # noqa: BLE001
                log(f"[train-pp] checkpoint write died ({werr!r}); the "
                    "previous checkpoint stands")
        if isinstance(e, DeviceLossError):
            e.loss_by_step, e.next_step = loss_by_step, next_step
            e.first_step_s, e.step_s = first_step_s, step_s
            e.checkpoint_records = ck.records if ck is not None else []
        raise
    finally:
        pipe.stop()
        if runner is not None:
            runner.close()
    res = {"losses": losses, "loss_by_step": loss_by_step,
           "final_loss": losses[-1] if losses else None,
           "steps": len(losses), "start_step": start_step,
           "next_step": next_step, "status": status,
           "first_step_s": first_step_s, "wall_s": time.time() - t_start,
           "median_step_s": monitor.median_step,
           "schedule": spec.table.name, "grad_norms": gnorms, "lrs": lrs,
           "step_s": step_s, "params": params, "opt_state": opt_state,
           "checkpoint_records": ck.records if ck is not None else []}
    if offload:
        res["offload"] = offload_report(tc, spec, runner,
                                        collect_wait_s=collect_wait_s)
        res["host_optimizer"] = runner.opt
    return res


def offload_report(tc: TrainConfig, spec, runner, *,
                   collect_wait_s: float) -> Dict:
    """Measured offload overlap against the paper's Eq. (5)/(7) model (at
    tp=1: one card), with the reference's keys, plus what the runner
    measured (:meth:`ChronosOffloadRunner.measured`: host update seconds,
    and on a card the copies' milliseconds and GB/s).  The model's
    ``pcie_gbps`` and ``cpu_flops`` are the plan's inputs, not
    measurements."""
    from repro_torch.core.analysis import offload_timing
    plan, shape = tc.plan, tc.shape
    ot = offload_timing(
        tc.model, seq_len=shape.seq_len, microbatch=spec.mbB,
        pp=spec.table.P, tp=1, pcie_gbps=plan.offload.pcie_gbps,
        cpu_flops=plan.offload.cpu_flops,
        offload_frac=plan.offload.num_offload_chunks / plan.num_chunks)
    submits = max(int(runner.stats["submits"]), 1)
    return {
        "submits": int(runner.stats["submits"]),
        "overlapped": int(runner.stats["overlapped"]),
        "measured_overlap_frac": runner.stats["overlapped"] / submits,
        "collect_wait_s": collect_wait_s,
        "eq5_offload_ok": ot.offload_ok,
        "eq7_upload_ok": ot.upload_ok,
        "predicted_overlap_ratio": ot.overlap_ratio,
        **runner.measured(),
    }
