"""Elastic scaling: re-plan the mesh when devices fail or join (own copy
of ``repro/ft/elastic.py``).

On a real cluster the runtime sees device loss as a failed collective /
missing heartbeat; the driver then (1) drops to the last checkpoint,
(2) re-plans the mesh over the surviving devices, (3) re-shards the
restored state (checkpoints are topology-independent), (4) rescales the
per-replica batch so the global batch is preserved.

The reference's ``reshard`` (``jax.device_put`` onto a new mesh's
shardings) has no counterpart: on one card there is nothing to reshard;
the elastic driver (:mod:`repro_torch.ft.elastic_pipeline`) re-plans
only the number of virtual stages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class MeshRequirements:
    """Divisibility constraints from the model/plan."""
    tp_divides: int             # num_kv_heads * head_dim etc.
    global_batch: int
    min_tp: int = 1
    pp: int = 1                 # desired pipeline stages
    # smallest pipeline depth worth running: 0 keeps pp fixed at
    # ``pp`` (the historical behaviour); >= 1 lets the planner shrink
    # the pipeline axis to P-1, P-2, ... when devices are lost — the
    # layer layout is re-derived by StageLayout.build at the new P and
    # parameters live-migrate via remap_blocks_elastic.
    min_pp: int = 0
    # largest per-replica batch a device can hold: 0 = unbounded; when
    # set, a shrunken dp keeps the global batch by grad accumulation
    # (dp * per_replica_batch * grad_accum_scale == global_batch).
    max_per_replica_batch: int = 0


@dataclass(frozen=True)
class ElasticDecision:
    dp: int
    tp: int
    pp: int
    devices_used: int
    per_replica_batch: int
    grad_accum_scale: int       # extra microbatch accumulation to keep
    #                             the global batch when dp shrank


def _grad_accum(per_replica_total: int, max_prb: int) -> int:
    """Smallest divisor ``g`` of ``per_replica_total`` such that the
    resident per-replica batch ``per_replica_total // g`` fits under
    ``max_prb`` (0 = no bound -> 1): the grad-accum fallback that keeps
    the global batch exact when dp shrank."""
    if not max_prb or per_replica_total <= max_prb:
        return 1
    for g in range(2, per_replica_total + 1):
        if per_replica_total % g == 0 and per_replica_total // g <= max_prb:
            return g
    return per_replica_total


def plan_mesh(n_devices: int, req: MeshRequirements,
              prefer_tp: int = 0) -> Optional[ElasticDecision]:
    """Choose (dp, tp, pp) with dp*tp*pp <= n_devices maximizing
    utilization, respecting tp | tp_divides and dp | global_batch, with
    grad-accum fallback when dp must shrink below the original (the
    per-replica batch exceeding ``req.max_per_replica_batch`` is split
    into ``grad_accum_scale`` accumulated sub-batches, so
    ``dp * per_replica_batch * grad_accum_scale == global_batch`` always
    holds exactly).  When ``req.min_pp >= 1`` the pipeline axis itself
    is elastic: pp is searched from ``req.pp`` down to ``min_pp``,
    preferring the deepest pipeline among device-count ties (the
    closest layout, so elastic migration moves the fewest layers)."""
    best: Optional[ElasticDecision] = None
    pps = [req.pp] if not req.min_pp else \
        range(req.pp, req.min_pp - 1, -1)
    for pp in pps:
        for tp in range(req.tp_divides, 0, -1):
            if req.tp_divides % tp or tp < req.min_tp:
                continue
            if prefer_tp and tp != prefer_tp and best is not None:
                continue
            dp = (n_devices // pp) // tp
            if dp < 1:
                continue
            # shrink dp to a divisor of global_batch
            while dp > 1 and req.global_batch % dp:
                dp -= 1
            used = dp * tp * pp
            per_total = req.global_batch // dp
            gas = _grad_accum(per_total, req.max_per_replica_batch)
            cand = ElasticDecision(
                dp=dp, tp=tp, pp=pp, devices_used=used,
                per_replica_batch=per_total // gas,
                grad_accum_scale=gas)
            if best is None or cand.devices_used > best.devices_used or (
                    cand.devices_used == best.devices_used and
                    (cand.pp, cand.tp) > (best.pp, best.tp)):
                best = cand
    return best


def simulate_failures(n_devices: int, failed: Sequence[int],
                      req: MeshRequirements) -> Optional[ElasticDecision]:
    """Decision after losing ``failed`` device ids."""
    return plan_mesh(n_devices - len(set(failed)), req)

