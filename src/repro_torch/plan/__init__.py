"""``repro_torch.plan`` — memory-budget design-space planner.

Public API:

- :func:`plan_under_budget` — one-call planner: ModelConfig + (pp, tp)
  + HBM budget -> :class:`ExecutablePlan` (best feasible schedule /
  recompute / offload combination).
- :func:`enumerate_points` / :class:`PlannerQuery` — the full evaluated
  design space, for design-space sweeps.
- :class:`DesignPoint` — one evaluated candidate (schedule metrics,
  byte-level memory, max trainable layers, offload overlap, score).
- :class:`ExecutablePlan` — winning point bound to its query; builds
  the validated ``Schedule``, compiled ``TaskTable``, and a
  ``ParallelPlan`` that ``repro_torch.launch.train.train_pipeline``
  trains.
- :func:`replan_for_pp` — elastic re-solve: the same query at a new
  pipeline depth (device loss -> P-1, rejoin -> back to P), the
  elastic path's re-plan (the elastic trainer is
  :func:`repro_torch.ft.elastic_pipeline.train_elastic`).
"""
from repro_torch.plan.planner import (  # noqa: F401
    DesignPoint, ExecutablePlan, PlannerQuery, enumerate_points,
    plan_under_budget, replan_for_pp)
