"""Pipeline training step of the port (``make_pipeline_train_step`` of
``repro/launch/steps.py``, on one device: no shardings, no compressed
gradient psum, no offload)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ParallelPlan, ShapeConfig)


def plan_schedule_kwargs(plan: ParallelPlan) -> Dict:
    """Schedule-generator kwargs the plan implies: the number of
    rematerialized chunks for ``chronos_recomp``; other generators need
    nothing."""
    rc = plan.recompute
    if plan.schedule == "chronos_recomp" and rc.mode == "chronos":
        return {"recomp_chunks": min(rc.num_recomp_chunks,
                                     max(plan.num_chunks - 1, 1))}
    return {}


def make_pipeline_train_step(cfg: ModelConfig, shape: ShapeConfig,
                             plan: ParallelPlan, ocfg: OptimizerConfig, *,
                             P: int, device):
    """ChronosPipe train step over ``P`` virtual stages on ``device``.
    Returns ``(step, m, mbB, spec)``: ``step(params, opt_state, batch)
    -> (params, opt_state, metrics)`` with ``batch["tokens"]`` [m, mbB,
    seq_len], and the built ``PipelineSpec``.

    The optimizer is the fused-AdamW kernel (one launch per parameter
    leaf) exactly where the reference fuses its optimizer into the
    executor: ``kernels="fused"`` and a split-backward table (W tasks);
    otherwise the phase-separate update without the kernel."""
    from repro_torch.core.pipeline_runtime import (make_pipeline_spec,
                                                   make_train_update_fn)
    if plan.offload.enabled:
        raise NotImplementedError(
            "Chronos-Offload (plan.offload.enabled) is not ported yet")
    mbB = plan.microbatch_size
    m = plan.num_microbatches or max(2, shape.global_batch // mbB)
    spec = make_pipeline_spec(
        cfg, P=P, v=plan.num_chunks, m=m, microbatch=mbB,
        seq_len=shape.seq_len, schedule=plan.schedule, kernels=plan.kernels,
        **plan_schedule_kwargs(plan))
    fuse_opt = plan.kernels == "fused" and spec.table.has_w
    step = make_train_update_fn(spec, device, ocfg, m, use_kernel=fuse_opt)
    return step, m, mbB, spec
