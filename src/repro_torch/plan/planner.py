"""Memory-budget design-space planner (paper Figs. 9b/15/16; own copy of
``repro/plan/planner.py``).

Given a :class:`~repro_torch.configs.base.ModelConfig`, a (pp, tp) shape,
and an HBM budget, search the registered schedule families x recompute
ratio x offload depth x seq-chunk count x **placement** (interleaved
striping vs the V-shape fold-back of *Pipeline Parallelism with
Controllable Memory* — the axis *OptPipe* shows is jointly optimizable
with scheduling) using the schedule IR's constructed metrics (peak
activation, bubble, ideal-compute fraction) and the byte-level
:class:`~repro_torch.core.analysis.MemoryModel`, and emit an
*executable* plan: a :class:`~repro_torch.configs.base.ParallelPlan`
plus the constructed :class:`~repro_torch.core.schedule.Schedule` and
compiled :class:`~repro_torch.core.tasktable.TaskTable` the pipeline
executor plays.  Every query is pure host arithmetic and equals the
reference's point for point.

This is the selective-recompute-vs-memory tradeoff of "Pipeline
Parallelism with Controllable Memory" (Qi et al.) and the
schedule/memory co-optimization of "OptPipe" (Li et al.), restricted to
the closed design space this repo constructs exactly — so the search is
exhaustive enumeration, not an MILP.

Example (the paper's llama70b testbed)::

    from repro_torch.configs.llama70b_paper import CONFIG
    from repro_torch.plan import plan_under_budget
    ep = plan_under_budget(CONFIG, pp=8, tp=8, hbm_bytes=64e9)
    ep.point.schedule, ep.point.offload_chunks
    ep.schedule()          # validated Schedule
    ep.task_table()        # compiled TaskTable
    ep.parallel_plan()     # ParallelPlan for launch.train.train_pipeline

On one card, ``P = ep.query.pp`` virtual stages run in lockstep
(:func:`repro_torch.launch.train.train_pipeline`), so a per-device
budget is the card's memory divided by ``pp``.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import (ModelConfig, OffloadConfig,
                                      ParallelPlan, RecomputeConfig)
from repro_torch.core import schedules as S
from repro_torch.core.analysis import (MemoryModel, max_trainable_layers,
                                       offload_timing)

GB = 1e9


@dataclass(frozen=True)
class PlannerQuery:
    """One design-space question: what fits under ``hbm_bytes``?"""
    cfg: ModelConfig
    pp: int
    tp: int
    hbm_bytes: float
    microbatch: int = 2
    seq_len: int = 4096
    reserve: float = 2.0e9          # workspace/fragmentation headroom
    max_v: int = 3                  # largest chunk count searched
    max_seq_chunks: int = 4         # largest sequence-chunk count searched
                                    # (only counts dividing seq_len - 1
                                    # are executable, see _seq_counts)
    # placement axis: which layer->device assignments to search.  The
    # V-shape family (v_min / v_half / v_zb) only enters the space when
    # "vshape" is listed; restrict to ("interleaved",) for the
    # pre-placement design space.
    placements: Tuple[str, ...] = ("interleaved", "vshape")
    # activation-estimator calibration (1.0 = the Megatron-selective
    # accounting of MemoryModel; the reference's benchmarks pass a scale
    # that reproduces the paper's full-storage-no-SP accounting)
    act_scale: float = 1.0
    # Chronos-Offload feasibility model inputs (Eq. 4-7)
    gpu_flops: float = 100e12
    pcie_gbps: float = 32.0
    cpu_flops: float = 2.0e12

    @property
    def microbatch_tokens(self) -> int:
        return self.microbatch * self.seq_len

    def memory_model(self) -> MemoryModel:
        mm = MemoryModel.build(self.cfg, tp=self.tp)
        if self.act_scale != 1.0:
            mm = dataclasses.replace(
                mm,
                act_per_token_layer=mm.act_per_token_layer * self.act_scale)
        return mm


@dataclass(frozen=True)
class DesignPoint:
    """One evaluated (schedule, recompute, offload, seq-chunk)
    candidate."""
    schedule: str                   # registry name
    sched_kwargs: Tuple[Tuple[str, object], ...]
    v: int
    recomp_chunks: int              # shallowest chunks replayed (R tasks)
    uniform_recomp: float           # 1F1B+R-style fraction (else 0)
    offload_chunks: int             # deepest chunks on the host optimizer
    # schedule-IR metrics (units of m_a / fractions)
    act_frac: float
    bubble: float
    compute_frac: float
    # byte-level evaluation under the query
    act_bytes: float
    state_bytes: float
    total_bytes: float
    fits: bool
    max_layers: int                 # max trainable layers under the budget
    offload_overlap: float          # Eq. (5) hidden fraction (1.0 = free)
    score: float                    # throughput proxy used for ranking
    seq_chunks: int = 1             # sequence chunks (repro_torch.seqpipe)
    placement: str = "interleaved"  # layer->device assignment axis

    @property
    def offload_frac(self) -> float:
        return self.offload_chunks / self.v if self.v else 0.0

    def describe(self) -> str:
        bits = [self.schedule if self.v < 2
                else f"{self.schedule}(v={self.v})"]
        if self.seq_chunks > 1:
            bits.append(f"s={self.seq_chunks}")
        if self.recomp_chunks:
            bits.append(f"rc={self.recomp_chunks}")
        if self.uniform_recomp:
            bits.append(f"R={self.uniform_recomp:.0%}")
        if self.offload_chunks:
            bits.append(f"offload={self.offload_chunks}/{self.v}")
        return "+".join(bits)


class ExecutablePlan:
    """A winning :class:`DesignPoint` bound to its query — buildable
    into the exact artifacts the runtime consumes."""

    def __init__(self, query: PlannerQuery, point: DesignPoint,
                 m: Optional[int] = None):
        self.query = query
        self.point = point
        self.m = m or 4 * query.pp

    def schedule(self):
        """Construct + validate the winning schedule."""
        return S.get_schedule(self.point.schedule, self.query.pp, self.m,
                              **dict(self.point.sched_kwargs))

    def task_table(self):
        from repro_torch.core.tasktable import (build_task_table,
                                                validate_table)
        tab = build_task_table(self.schedule())
        validate_table(tab)
        return tab

    def parallel_plan(self, *, pp_axis: Optional[str] = "pp",
                      microbatch_size: Optional[int] = None,
                      zero_stage: int = 1,
                      kernels: str = "fused") -> ParallelPlan:
        """The point as the port's :class:`ParallelPlan`, for
        :func:`repro_torch.launch.train.train_pipeline` with ``P =
        self.query.pp``.  Field by field against the reference's plan:

        - ``schedule``, ``num_chunks`` (v), ``seq_chunks`` and
          ``microbatch_size`` as the reference sets them; the microbatch
          count stays 0 (``global_batch // microbatch_size``), and
          ``self.m`` is the count the point was scored at;
        - ``recompute``: ``chronos`` with the point's recomputed chunks,
          ``uniform`` with its fraction, else ``none``;
        - ``offload``: enabled with the point's deep chunks, the query's
          Eq. (5)/(7) inputs;
        - ``kernels`` (the port's field): "fused" runs the CUDA kernels
          (on a CPU tensor each wrapper runs its plain version), "plain"
          runs no kernel;
        - ``zero_stage`` 0-3 is the plan's field (0: the optimizer
          state replicated; 1 and 2: each data-parallel rank's fsdp
          slice of the blocks' state on a mesh; 3: of the block weights
          too, gathered at use); another stage raises ValueError;
        - ``pp_axis`` has no field: the mesh's pipe axis is always "pp",
          so any other name raises ValueError.

        A point's ``tp`` (``self.query.tp``) trains on a mesh of that tp
        (``train_pipeline(mesh=)`` with a
        :class:`~repro_torch.launch.mesh.Mesh` of tp ranks a stage)."""
        if pp_axis != "pp":
            raise ValueError(
                f"pp_axis={pp_axis!r}: the port's mesh names its pipe axis "
                f"'pp' (its {self.query.pp} pipeline stages; pp_axis 'pp' "
                f"only, virtual stages on one card or ranks of a mesh)")
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage={zero_stage}: expected 0, 1, 2 "
                             f"or 3")
        p = self.point
        if p.recomp_chunks:
            rc = RecomputeConfig(mode="chronos",
                                 num_recomp_chunks=p.recomp_chunks)
        elif p.uniform_recomp:
            rc = RecomputeConfig(mode="uniform",
                                 uniform_frac=p.uniform_recomp)
        else:
            rc = RecomputeConfig(mode="none")
        off = OffloadConfig(enabled=p.offload_chunks > 0,
                            num_offload_chunks=max(p.offload_chunks, 1),
                            pcie_gbps=self.query.pcie_gbps,
                            cpu_flops=self.query.cpu_flops)
        return ParallelPlan(
            schedule=p.schedule, num_chunks=p.v, seq_chunks=p.seq_chunks,
            microbatch_size=(microbatch_size
                             if microbatch_size is not None
                             else self.query.microbatch),
            recompute=rc, offload=off, zero_stage=zero_stage,
            kernels=kernels)

    def summary(self) -> Dict:
        p = self.point
        return {
            "pick": p.describe(), "schedule": p.schedule, "v": p.v,
            "placement": p.placement,
            "seq_chunks": p.seq_chunks,
            "recomp_chunks": p.recomp_chunks,
            "offload_chunks": p.offload_chunks,
            "act_frac_of_ma": round(p.act_frac, 4),
            "bubble": round(p.bubble, 4),
            "compute_frac": round(p.compute_frac, 4),
            "total_GB": round(p.total_bytes / GB, 2),
            "hbm_GB": round(self.query.hbm_bytes / GB, 2),
            "max_layers": p.max_layers,
            "offload_overlap": round(p.offload_overlap, 4),
            "score": round(p.score, 4),
        }


# ---------------------------------------------------------------------------
# candidate space
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _metrics(name: str, P: int, m: int,
             kwargs: Tuple[Tuple[str, object], ...]):
    """(act_frac, bubble, compute_frac, has_cooldown, kv_frac) of a
    constructed schedule — cached, the same schedule backs many
    byte-level points.  ``kv_frac`` is the seqpipe KV-carry residency:
    the worst per-stage count of (chunk-slot) full-sequence K/V buffers
    in flight (lifetime F[mb,0] -> B[mb,0], the executor's ring
    sizing), as a fraction of one whole-net microbatch KV (0 for
    unchunked schedules)."""
    from repro_torch.core.schedule import B as _B, F as _F
    sched = S.get_schedule(name, P, m, **dict(kwargs))
    gaps = sched.warmup_cooldown_bubbles(stage=P - 1)
    kv_frac = 0.0
    if sched.n_seq > 1:
        idx = sched.by_key()
        worst = 0
        for s in range(P):
            tot = 0
            for c in range(sched.v):
                events = []
                for i in range(m):
                    events.append((idx[(_F, i, c, s, 0)].start, 1))
                    events.append((idx[(_B, i, c, s, 0)].end, -1))
                events.sort()
                cur = pk = 0
                for _, d in events:
                    cur += d
                    pk = max(pk, cur)
                tot += pk
            worst = max(worst, tot)
        kv_frac = worst / (sched.v * P)
    return (sched.peak_activation(count_transient=False),
            sched.bubble_ratio(),
            sched.ideal_compute_fraction(),
            sum(b - a for a, b in gaps) > 1e-9,
            kv_frac)


def _seq_counts(q: PlannerQuery):
    """Executable sequence-chunk counts: the runtime slices the
    ``seq_len - 1`` next-token positions into equal chunks, so only
    divisors qualify (long-context shapes use 2^k + 1 seq lens)."""
    return [k for k in range(2, q.max_seq_chunks + 1)
            if (q.seq_len - 1) % k == 0]


def _candidates(q: PlannerQuery):
    """(schedule name, kwargs, v, recomp_chunks, uniform_recomp,
    seq_chunks, placement)."""
    out = []
    for r in (0.0, 0.25, 0.5, 0.75):
        out.append(("1f1b", {"recomp": r} if r else {}, 1, 0, r, 1,
                    "interleaved"))
    out.append(("zb_h1", {}, 1, 0, 0.0, 1, "interleaved"))
    for v in range(2, q.max_v + 1):
        out.append(("interleaved", {"v": v}, v, 0, 0.0, 1, "interleaved"))
        out.append(("chronos", {"v": v}, v, 0, 0.0, 1, "interleaved"))
        out.append(("chronos_zb", {"v": v}, v, 0, 0.0, 1, "interleaved"))
        for rc in range(1, v):
            out.append(("chronos_recomp", {"v": v, "recomp_chunks": rc},
                        v, rc, 0.0, 1, "interleaved"))
    out.append(("chronos_zero2", {"v": 2, "group": 2}, 2, 0, 0.0, 1,
                "interleaved"))
    # sequence-chunked family (repro_torch.seqpipe): long-context points
    for k in _seq_counts(q):
        out.append(("seq1f1b", {"n_seq": k}, 1, 0, 0.0, k, "interleaved"))
        out.append(("chronos_seq", {"v": 2, "n_seq": k}, 2, 0, 0.0, k,
                    "interleaved"))
        out.append(("chronos_seq",
                    {"v": 2, "n_seq": k, "recomp_chunks": 1},
                    2, 1, 0.0, k, "interleaved"))
    # V-shape controllable-memory family (repro_torch.core.vshape): the
    # placement axis — device d holds blocks d and 2P-1-d, split B/W
    if "vshape" in q.placements:
        for name in ("v_min", "v_half", "v_zb"):
            out.append((name, {}, 2, 0, 0.0, 1, "vshape"))
    return [c for c in out if c[6] in q.placements]


def enumerate_points(q: PlannerQuery) -> List[DesignPoint]:
    """Evaluate the full design space under ``q``, best score first.

    Offload depths: 0..v-1 deepest chunks for the chronos family (whose
    cooldown bubbles are the §5.1 overlap windows); non-chronos
    schedules get depth 0 only."""
    mm = q.memory_model()
    m_sched = 4 * q.pp
    L = q.cfg.num_layers
    points = []
    for name, kw, v, rc, unif, nsq, plname in _candidates(q):
        kwt = tuple(sorted(kw.items()))
        act_frac, bubble, cf, has_cooldown, kv_frac = _metrics(
            name, q.pp, m_sched, kwt)
        depths = range(v if (has_cooldown and name.startswith("chronos"))
                       else 1)
        for n_off in depths:
            if n_off >= v:
                continue
            off_frac = n_off / v
            act = act_frac * mm.m_a(q.microbatch_tokens, L)
            # seqpipe: the executor keeps a full-sequence KV buffer plus
            # its dKV twin per in-flight microbatch (no 1/n_seq shrink)
            act += 2.0 * kv_frac * mm.kv_a(q.microbatch_tokens, L)
            state = mm.model_state(L, q.pp, q.tp, offload_frac=off_frac)
            total = act + state + q.reserve
            overlap = 1.0
            if n_off:
                overlap = offload_timing(
                    q.cfg, seq_len=q.seq_len, microbatch=q.microbatch,
                    pp=q.pp, tp=q.tp, gpu_flops=q.gpu_flops,
                    pcie_gbps=q.pcie_gbps, cpu_flops=q.cpu_flops,
                    offload_frac=off_frac).overlap_ratio
            # throughput proxy: useful-compute fraction, degraded by the
            # exposed (non-overlapped) share of the offload work
            score = cf * (1.0 - 0.1 * (1.0 - overlap))
            max_l = max_trainable_layers(
                q.cfg, hbm_bytes=q.hbm_bytes, pp=q.pp, tp=q.tp,
                microbatch_tokens=q.microbatch_tokens,
                act_frac_of_ma=act_frac, offload_frac=off_frac,
                reserve=q.reserve, memory_model=mm)
            points.append(DesignPoint(
                schedule=name, sched_kwargs=kwt, v=v, recomp_chunks=rc,
                uniform_recomp=unif, offload_chunks=n_off,
                act_frac=act_frac, bubble=bubble, compute_frac=cf,
                act_bytes=act, state_bytes=state, total_bytes=total,
                fits=total <= q.hbm_bytes, max_layers=max_l,
                offload_overlap=overlap, score=score, seq_chunks=nsq,
                placement=plname))
    points.sort(key=lambda p: (-p.score, p.total_bytes))
    return points


def plan_under_budget(cfg: ModelConfig, *, pp: int, tp: int,
                      hbm_bytes: float, **kw) -> ExecutablePlan:
    """Best feasible plan for ``cfg`` under ``hbm_bytes`` per device:
    highest throughput proxy among the points that fit; byte ties break
    toward lower memory.  Raises ``ValueError`` (naming the closest
    point) when nothing in the design space fits."""
    q = PlannerQuery(cfg=cfg, pp=pp, tp=tp, hbm_bytes=hbm_bytes, **kw)
    points = enumerate_points(q)
    feasible = [p for p in points if p.fits]
    if not feasible:
        closest = min(points, key=lambda p: p.total_bytes)
        raise ValueError(
            f"no schedule fits {hbm_bytes / GB:.1f} GB for "
            f"{cfg.name} (pp={pp}, tp={tp}); closest is "
            f"{closest.describe()} at {closest.total_bytes / GB:.1f} GB")
    return ExecutablePlan(q, feasible[0])


def replan_for_pp(plan: ExecutablePlan, new_pp: int,
                  m: Optional[int] = None) -> ExecutablePlan:
    """Re-solve an :class:`ExecutablePlan`'s query at a different
    pipeline depth — the elastic path: device loss shrinks the pp axis
    to P-1 (device return grows it back), every other query constraint
    (budget, tp, microbatch shape, placement space) is unchanged.  The
    microbatch count defaults to the original plan's ``m`` so the
    resumed run keeps the same global batch per step."""
    assert new_pp >= 1, f"pp must be >= 1, got {new_pp}"
    q = dataclasses.replace(plan.query, pp=new_pp)
    try:
        points = enumerate_points(q)
    except Exception as e:
        # pp=1 (and other degenerate depths) have no schedulable points;
        # surface the same error type as "nothing fits" so elastic
        # callers handle one exception
        raise ValueError(
            f"no schedule enumerable at pp={new_pp} for "
            f"{q.cfg.name}: {e}") from e
    feasible = [p for p in points if p.fits]
    if not feasible:
        closest = min(points, key=lambda p: p.total_bytes)
        raise ValueError(
            f"no schedule fits at pp={new_pp} for {q.cfg.name}; "
            f"closest is {closest.describe()} at "
            f"{closest.total_bytes / GB:.1f} GB")
    return ExecutablePlan(q, feasible[0], m=m or plan.m)
