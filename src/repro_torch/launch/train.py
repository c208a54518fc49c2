"""Training entry points of the port, each on one device, without the
reference's checkpointer, health monitor, fault injector and watchdog:

- :func:`train`: the single-device driver (``train`` of
  ``repro/launch/train.py``): every microbatch's loss through
  ``LM.loss`` under Chronos-Recomp, gradients summed in fp32, then AdamW;
- :func:`train_pipeline`: ChronosPipe pipeline training under any
  generator of the schedule registry (the V-shape family with its
  fold-back placement; the sequence-chunked family with
  ``plan.seq_chunks`` chunks per microbatch), with Chronos-Offload (the
  deepest chunks' AdamW on the host) when ``plan.offload.enabled``.

    from repro_torch.launch.train import train, train_pipeline
    out = train(tc)                                # on the card
    out = train(tc, device="cpu")                  # plain versions
    out = train_pipeline(tc, P=4)                  # on the card
    out = train_pipeline(tc, P=2, device="cpu")    # plain versions

``P`` virtual stages run in lockstep on the device (the reference maps
them onto a mesh axis).  Both run on CUDA unless ``device="cpu"``; a CUDA
request without a card raises.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import TrainConfig
from repro_torch.core.pipeline_runtime import init_pipeline_params
from repro_torch.data import DataPipeline, synthetic_source
from repro_torch.launch.steps import (make_pipeline_train_step,
                                      make_train_step, offload_kept)
from repro_torch.optim import adamw_init
from repro_torch.optim.offload import (ChronosOffloadRunner,
                                       merge_deep_shallow)


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

    Left out against the reference: the checkpointer and the health
    monitor (restart, straggler detection; ROADMAP A.6).  The update is
    the plain AdamW, as the reference's ``train()`` runs it: the
    fused-AdamW kernel runs only inside the pipeline executor.

    Returns ``losses``, ``final_loss``, ``steps``, ``wall_s`` and
    ``median_step_s`` as the reference does, plus per-step
    ``grad_norms``, ``lrs`` and ``step_s`` and the final ``params`` and
    ``opt_state``."""
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
                        prefetch=2).start()
    losses, gnorms, lrs, step_s = [], [], [], []
    t_start = time.time()
    try:
        for step in range(steps):
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
            if step % tc.log_every == 0:
                log(f"[train] step {step} loss {loss:.4f} "
                    f"gnorm {gnorms[-1]:.3f} lr {lrs[-1]:.3e} ({dt:.2f}s)")
    finally:
        pipe.stop()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "steps": len(losses), "wall_s": time.time() - t_start,
            "median_step_s": statistics.median(step_s) if step_s else None,
            "grad_norms": gnorms, "lrs": lrs, "step_s": step_s,
            "params": params, "opt_state": opt_state}


def train_pipeline(tc: TrainConfig, *, P: int, device="cuda",
                   steps: Optional[int] = None, data_source=None,
                   params=None, log: Callable[[str], None] = print) -> Dict:
    """Train ``steps`` (default ``tc.optimizer.total_steps``) steps.
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

    Returns ``losses``, ``final_loss``, ``steps``, ``wall_s``,
    ``median_step_s`` and ``schedule`` as the reference does, plus
    per-step ``grad_norms``, ``lrs`` and ``step_s`` and the final
    ``params`` and ``opt_state``; under offload also ``offload``
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
    runner = None
    if offload:
        kept, deep = offload_kept(params, plan)
        opt_state = adamw_init(kept)
        runner = ChronosOffloadRunner(deep, ocfg)
    else:
        opt_state = adamw_init(params)

    def fold_pending():
        merge_deep_shallow(kept["blocks"], runner.collect(),
                           out=params["blocks"])

    source = data_source or synthetic_source(cfg, shape.seq_len,
                                             seed=tc.seed)
    pipe = DataPipeline(source, global_batch=mbB * m, microbatches=m,
                        prefetch=2).start()
    losses, gnorms, lrs, step_s = [], [], [], []
    pending, collect_wait_s = False, 0.0
    t_start = time.time()
    try:
        for step in range(steps):
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
            out = step_fn(params, opt_state, batch)
            params, opt_state, metrics = out[:3]
            if offload:
                runner.submit(out[3], grad_div=m)   # grads down, host AdamW
                pending = True
            # the deep gradients are views of the step's accumulators:
            # held here, they would live through the next step
            del out
            loss = float(metrics["loss"])     # waits for the step
            dt = time.time() - t0
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            lrs.append(float(metrics["lr"]))
            step_s.append(dt)
            if step % tc.log_every == 0:
                log(f"[train-pp] step {step} loss {loss:.4f} "
                    f"gnorm {gnorms[-1]:.3f} lr {lrs[-1]:.3e} ({dt:.2f}s)")
        if pending:
            fold_pending()
    finally:
        pipe.stop()
        if runner is not None:
            runner.close()
    res = {"losses": losses, "final_loss": losses[-1] if losses else None,
           "steps": len(losses), "wall_s": time.time() - t_start,
           "median_step_s": statistics.median(step_s) if step_s else None,
           "schedule": spec.table.name, "grad_norms": gnorms, "lrs": lrs,
           "step_s": step_s, "params": params, "opt_state": opt_state}
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
