"""Pipeline-schedule IR, validity checkers, and metrics (own copy of
``repro/core/schedule.py``).

A schedule is a set of :class:`Task` objects with start times measured in
*grains*: one grain = T_fwd/(v*P) = the forward time of one (stage, chunk)
block of one microbatch (the paper's ``T_unit``).  Backward blocks take
``b`` grains (default 2, the paper's T_bwd = 2*T_fwd assumption) plus a
recompute prefix for rematerialized chunks.

Placement (:mod:`repro_torch.core.placement`): *stage* is the pipeline
position along a chunk's path (every dependency below is written in
stage space); which **device** executes a (stage, chunk) pair — and
which layer-block therefore lives there — is the schedule's pluggable
``placement``.  ``placement=None`` means the classic interleaved
striping (device = stage, block = ``c*P + s``, chunk 0 shallowest);
:class:`~repro_torch.core.placement.VShapePlacement` folds odd chunks back
(device = ``P-1-s``) so the chunk hops are device-local and device
``d`` holds blocks ``d`` and ``2P-1-d`` (the V-shape family of
*Pipeline Parallelism with Controllable Memory*).  Occupancy (no
overlap), comm latency (``tc`` applies only to device-*crossing*
edges), and ``peak_activation`` are all accounted per device.

Dependencies:
    F(i,c,s)  <- F(i,c,s-1)            (s>0)
              <- F(i,c-1,P-1)          (s==0, c>0)
    B(i,c,s)  <- B(i,c,s+1)            (s<P-1)
              <- F(i,c,P-1)            (s==P-1, c==v-1)
              <- B(i,c+1,0)            (s==P-1, c<v-1)
    and B(i,c,s) <- F(i,c,s) always.
For tasks with a recompute prefix (dur = recomp + b), only the *backward
sub-block* (the last ``b`` grains) needs the upstream gradient; the
recompute prefix depends only on the stored boundary checkpoint.

Split backward (zero-bubble family, ZB-H1 / OptPipe lineage): a schedule
may carry a third task kind ``W`` (weight-gradient).  There the ``B``
task is the *input-gradient* step only (it unblocks the upstream stage
and releases the block's activation), while ``W(i,c,s)`` computes the
weight gradients later from stashed residuals:

    W(i,c,s)  <- B(i,c,s)              (same stage, any later slot)

``W`` has no cross-stage edges and sends nothing.  Activation accounting
is unchanged — the activation is released at the end of ``B``, not ``W``
(the W residual stash is the boundary payload + upstream gradient, whose
ring depth the task-table compiler sizes separately).

Explicit recompute (Chronos-Recomp family): a schedule may carry a
fourth task kind ``R`` (rematerialization).  ``R(i,c,s)`` replays the
forward of block (i,c,s) from its stored boundary checkpoint; the
block's ``B`` then consumes the rematerialized internals:

    R(i,c,s)  <- F(i,c,s)              (same stage, any later slot)
    B(i,c,s)  <- R(i,c,s)              (same stage, B starts at/after R end)

``R`` has no cross-stage edges and sends nothing.  A chunk either has an
R task for every (mb, stage) or for none — mixed per-microbatch
recompute is not representable.  For chunks with R tasks the ``B`` task
is a plain ``b``-grain backward (``recomp == 0``); the legacy encoding —
a recompute *prefix* folded into ``B`` (``dur = recomp + b``) — remains
supported for the uniform-recompute baselines (1F1B+R, GPipe+R) where
the replay is never separately schedulable.

Sequence chunking (:mod:`repro_torch.seqpipe`, Seq1F1B / SlimPipe
lineage): a schedule may split every microbatch along the sequence
dimension into ``n_seq`` causally-ordered chunks; ``Task.seq`` carries
the chunk index ``q`` and the scheduling unit becomes (mb, layer-chunk,
stage, seq).  The chunks are *not* independent — causal attention
threads a KV prefix through the forwards and a dKV accumulation through
the backwards, both stage-local:

    F(i,c,s,q)  <- F(i,c,s,q-1)        (q>0, same stage: KV prefix)
    B(i,c,s,q)  <- B(i,c,s,q+1)        (q<n_seq-1, same stage: dKV carry)

and every cross-stage edge above applies per sequence chunk (payloads
shrink to 1/n_seq of a microbatch boundary).  The turnaround only
exists for the *last* chunk; earlier chunks' final-stage backwards are
unblocked by the dKV carry plus their own loss slice.  One grain is
then T_fwd/(v*P*n_seq) and a unit's activation grain is
1/(v*P*n_seq) of m_a.

All constructed start times are exact multiples of half a grain; the
module-level :data:`HALF`/:func:`to_half` helpers let schedule generators
do occupancy arithmetic in integer half-grains with no float slop.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from repro_torch.core.placement import Placement

F, B, W, R = "F", "B", "W", "R"

_KIND_CODE = {F: 0, B: 1, W: 2, R: 3}

HALF = 2          # integer half-grains per grain


def to_half(t: float) -> int:
    """Exact conversion of a grain time to integer half-grains.

    Raises if ``t`` is not (numerically) on the half-grain lattice —
    schedule generators are required to stay on it, which is what lets
    occupancy checks use exact integer comparisons instead of 1e-9 slop.
    """
    h = round(t * HALF)
    if abs(h - t * HALF) > 1e-6:
        raise ValueError(f"time {t} is not a multiple of half a grain")
    return h


def from_half(h: int) -> float:
    return h / HALF


@dataclass
class Task:
    kind: str                    # "F" | "B" | "W" | "R"
    mb: int
    chunk: int
    stage: int
    start: float
    dur: float
    recomp: float = 0.0          # recompute prefix inside a B task
    comm: float = 0.0            # synchronous P2P stall folded into dur
    seq: int = 0                 # sequence-chunk index (seqpipe family)

    @property
    def end(self) -> float:
        return self.start + self.dur

    @property
    def grad_ready(self) -> float:
        return self.end

    @property
    def grad_needed_at(self) -> float:
        """Time the upstream gradient must be available (B tasks)."""
        return self.start + self.recomp

    def key(self):
        return (self.kind, self.mb, self.chunk, self.stage, self.seq)


@dataclass
class Schedule:
    name: str
    P: int
    v: int
    m: int
    f: float
    b: float
    tasks: List[Task]
    # chunk -> stored activation fraction while in flight (1.0 = full
    # residuals, ~0 = checkpoint-only because the chunk is recomputed)
    stored_frac: Dict[int, float] = dataclasses.field(default_factory=dict)
    meta: Dict = dataclasses.field(default_factory=dict)
    # weight-gradient duration (split-backward schedules only).  When the
    # schedule has W tasks, ``b`` is the input-gradient duration and
    # ``b + w`` must equal the fused backward cost.
    w: float = 0.0
    # sequence chunks per microbatch (seqpipe family; 1 = whole-sequence
    # tasks)
    n_seq: int = 1
    # (stage, chunk) -> device / layer-block mapping; None = interleaved
    # striping (device == stage), the pre-placement behavior
    placement: Optional[Placement] = None

    @property
    def pl(self) -> Placement:
        """The effective placement (identity/interleaved when unset)."""
        return self.placement if self.placement is not None \
            else Placement(self.P, self.v)

    @property
    def has_w(self) -> bool:
        return any(t.kind == W for t in self.tasks)

    @property
    def has_r(self) -> bool:
        return any(t.kind == R for t in self.tasks)

    def r_chunks(self) -> FrozenSet[int]:
        """Chunks rematerialized by explicit R tasks (empty for legacy
        recompute-prefix schedules)."""
        return frozenset(t.chunk for t in self.tasks if t.kind == R)

    # -- indexing ---------------------------------------------------------
    def by_key(self) -> Dict[Tuple, Task]:
        return {t.key(): t for t in self.tasks}

    def stage_tasks(self, s: int) -> List[Task]:
        return sorted([t for t in self.tasks if t.stage == s],
                      key=lambda t: t.start)

    def device_tasks(self, d: int) -> List[Task]:
        """Tasks executing on device ``d`` (== :meth:`stage_tasks` for
        the interleaved placement), in start order."""
        pl = self.pl
        return sorted([t for t in self.tasks
                       if pl.device(t.stage, t.chunk) == d],
                      key=lambda t: t.start)

    # -- vectorized task-array view ---------------------------------------
    def _arrays(self):
        """Numpy view of the task set: (kind, mb, chunk, stage, seq,
        start, dur, end, recomp) plus the dense key->index lookup
        ``ind[kind, mb, chunk, stage, seq]`` (-1 where absent) and the
        (stage, chunk) -> device map.  The vectorized ``check`` /
        ``peak_activation`` / ``retime_with_comm`` hot paths all run on
        these arrays instead of per-task Python objects."""
        ts = self.tasks
        n = len(ts)
        kind = np.fromiter((_KIND_CODE[t.kind] for t in ts), np.int64, n)
        mb = np.fromiter((t.mb for t in ts), np.int64, n)
        chunk = np.fromiter((t.chunk for t in ts), np.int64, n)
        stage = np.fromiter((t.stage for t in ts), np.int64, n)
        seq = np.fromiter((t.seq for t in ts), np.int64, n)
        start = np.fromiter((t.start for t in ts), np.float64, n)
        dur = np.fromiter((t.dur for t in ts), np.float64, n)
        recomp = np.fromiter((t.recomp for t in ts), np.float64, n)
        ind = -np.ones((4, self.m, self.v, self.P, self.n_seq), np.int64)
        ind[kind, mb, chunk, stage, seq] = np.arange(n)
        pl = self.pl
        dev_map = np.array([[pl.device(s, c) for c in range(self.v)]
                            for s in range(self.P)])
        return dict(kind=kind, mb=mb, chunk=chunk, stage=stage, seq=seq,
                    start=start, dur=dur, end=start + dur, recomp=recomp,
                    ind=ind, dev=dev_map)

    # -- validity ---------------------------------------------------------
    def check(self, tc: float = 0.0) -> None:
        P, v, m, ns = self.P, self.v, self.m, self.n_seq
        rcs = self.r_chunks()
        has_b = any(t.kind == B for t in self.tasks)
        kinds = (3 if self.has_w else 2) if has_b else 1
        n_expect = (kinds * P * v * m + len(rcs) * P * m) * ns
        assert len(self.tasks) == n_expect, \
            f"expected {n_expect} tasks, got {len(self.tasks)}"
        a = self._arrays()
        kind, mb, chunk, stage, seq = (a["kind"], a["mb"], a["chunk"],
                                       a["stage"], a["seq"])
        start, end, recomp, ind, dev = (a["start"], a["end"], a["recomp"],
                                        a["ind"], a["dev"])
        assert (ind >= 0).sum() == len(self.tasks), "duplicate task keys"
        gneed = start + recomp

        def expect(mask, dep_idx, ok_at, extra_tc, why):
            """All masked tasks' ``ok_at`` must be >= dep end (+ tc on
            device-crossing edges)."""
            if not mask.any():
                return
            di = dep_idx[mask]
            assert (di >= 0).all(), f"missing dep ({why})"
            need = end[di] + extra_tc[mask]
            ok = ok_at[mask]
            bad = ok < need - 1e-9
            if bad.any():
                i = np.flatnonzero(mask)[np.argmax(bad)]
                raise AssertionError(
                    f"{self.tasks[i].key()} starts {ok[bad][0]} before "
                    f"dep ({why}) at {need[bad][0]}")

        def edge_tc(m_, ps, pc):
            """tc on device-crossing edges, 0 on placement-local ones
            (ps/pc: producer stage/chunk arrays under mask m_)."""
            out = np.zeros(len(kind))
            out[m_] = np.where(dev[ps[m_], pc[m_]]
                               == dev[stage[m_], chunk[m_]], 0.0, tc)
            return out

        is_f, is_b = kind == 0, kind == 1
        is_w, is_r = kind == 2, kind == 3
        in_rcs = np.isin(chunk, list(rcs)) if rcs else np.zeros(
            len(kind), bool)

        # F deps
        m_ = is_f & (stage > 0)
        expect(m_, ind[0, mb, chunk, np.maximum(stage - 1, 0), seq],
               start, edge_tc(m_, np.maximum(stage - 1, 0), chunk),
               "fwd chain")
        m_ = is_f & (stage == 0) & (chunk > 0)
        expect(m_, ind[0, mb, np.maximum(chunk - 1, 0), P - 1, seq],
               start, edge_tc(m_, np.full_like(stage, P - 1),
                              np.maximum(chunk - 1, 0)), "fwd chunk hop")
        m_ = is_f & (seq > 0)
        expect(m_, ind[0, mb, chunk, stage, np.maximum(seq - 1, 0)],
               start, np.zeros(len(kind)), "kv prefix")
        # W / R deps
        expect(is_w, ind[1, mb, chunk, stage, seq], start,
               np.zeros(len(kind)), "own bwd")
        expect(is_r, ind[0, mb, chunk, stage, seq], start,
               np.zeros(len(kind)), "own fwd")
        # B deps
        expect(is_b, ind[0, mb, chunk, stage, seq], start,
               np.zeros(len(kind)), "own fwd")
        m_ = is_b & in_rcs
        if m_.any():
            assert (recomp[m_] == 0.0).all(), \
                "explicit R task and recompute prefix"
        expect(m_, ind[3, mb, chunk, stage, seq], start,
               np.zeros(len(kind)), "own remat")
        m_ = is_b & (seq < ns - 1)
        expect(m_, ind[1, mb, chunk, stage, np.minimum(seq + 1, ns - 1)],
               gneed, np.zeros(len(kind)), "dkv carry")
        m_ = is_b & (stage < P - 1)
        expect(m_, ind[1, mb, chunk, np.minimum(stage + 1, P - 1), seq],
               gneed, edge_tc(m_, np.minimum(stage + 1, P - 1), chunk),
               "bwd chain")
        m_ = is_b & (stage == P - 1) & (chunk < v - 1)
        expect(m_, ind[1, mb, np.minimum(chunk + 1, v - 1), 0, seq],
               gneed, edge_tc(m_, np.zeros_like(stage),
                              np.minimum(chunk + 1, v - 1)),
               "bwd chunk hop")
        m_ = is_b & (stage == P - 1) & (chunk == v - 1)
        expect(m_, ind[0, mb, chunk, stage, seq], gneed,
               np.zeros(len(kind)), "turnaround")

        # no overlap per device (== per stage for interleaved placement)
        d_of = dev[stage, chunk]
        order = np.lexsort((start, d_of))
        same = d_of[order][1:] == d_of[order][:-1]
        prev_end = end[order][:-1]
        nxt_start = start[order][1:]
        bad = same & (nxt_start < prev_end - 1e-9)
        if bad.any():
            i = np.argmax(bad)
            ta, tb = self.tasks[order[i]], self.tasks[order[i + 1]]
            raise AssertionError(
                f"overlap on device {d_of[order[i]]}: "
                f"{ta.key()}@{ta.start}+{ta.dur} vs {tb.key()}@{tb.start}")

    # -- metrics ----------------------------------------------------------
    def total_time(self) -> float:
        return max(t.end for t in self.tasks) - min(t.start
                                                    for t in self.tasks)

    def total_time_rel(self) -> float:
        """Total time in units of T_fwd (one microbatch full forward):
        grains are T_fwd/(v*P*n_seq), so divide by v*P*n_seq.  Use this
        to compare schedules with different chunk counts."""
        return self.total_time() / (self.v * self.P * self.n_seq)

    def bubble_ratio(self) -> float:
        """Mean idle+comm fraction inside the span (paper's bubble:
        synchronous P2P stalls count as bubble, not compute)."""
        span = self.total_time()
        busy = sum(t.dur - t.comm for t in self.tasks) / self.P
        return 1.0 - busy / span

    def ideal_compute_fraction(self) -> float:
        """1 - bubble - recompute overhead (paper Figs. 12/13).  Both
        recompute encodings count as overhead: the prefix inside legacy
        ``B`` tasks and the whole duration of explicit ``R`` tasks."""
        span = self.total_time()
        useful = sum(0.0 if t.kind == R else t.dur - t.recomp - t.comm
                     for t in self.tasks) / self.P
        return useful / span

    def peak_activation(self, per_stage: bool = False,
                        count_transient: bool = True):
        """Peak resident activation in units of m_a (whole-net activation
        of one microbatch), accounted per *device* (``per_stage=True``
        returns one entry per device; devices == stages under the
        interleaved placement).  Each (stage, chunk, mb) block holds
        1/(v*P)*stored_frac[chunk] of m_a from the start of its F until
        the end of its B, resident on the device the placement assigns
        to (stage, chunk).  Recomputed chunks additionally materialize
        their own block activation transiently during the replay — from
        the start of the explicit R task when the schedule has one, else
        from the start of the B task's recompute prefix; the paper's
        figures ignore this transient (Fig. 15 caption) — pass
        ``count_transient=False`` for paper-comparable numbers.

        Split-backward schedules: the activation is released at the end
        of the input-gradient ``B`` task; deferred ``W`` tasks hold no
        block activation (their residual stash is boundary-payload
        sized and accounted by the task-table compiler, not here).

        Sequence-chunked schedules: the unit shrinks to a partial-
        sequence grain 1/(v*P*n_seq) of m_a, alive from that seq
        chunk's F until its own B — early chunks of a microbatch stay
        resident until their (late) backwards, which the per-unit
        accounting captures exactly."""
        a = self._arrays()
        kind, chunk, stage, start, end, ind = (
            a["kind"], a["chunk"], a["stage"], a["start"], a["end"],
            a["ind"])
        unit = 1.0 / (self.v * self.P * self.n_seq)
        dev = a["dev"]
        frs = np.array([self.stored_frac.get(c, 1.0)
                        for c in range(self.v)])

        # resident block: +unit*fr at F start, -unit*fr at B end
        is_f, is_b = kind == 0, kind == 1
        fi, bi = np.flatnonzero(is_f), np.flatnonzero(is_b)
        times = [start[fi], end[bi]]
        deltas = [unit * frs[chunk[fi]], -unit * frs[chunk[bi]]]
        devs = [dev[stage[fi], chunk[fi]], dev[stage[bi], chunk[bi]]]
        if count_transient and (frs < 1.0).any():
            # transient rematerialized block: alive from the replay
            # (explicit R, or B's recompute prefix) until the backward
            # releases it
            tb = bi[frs[chunk[bi]] < 1.0]
            ri = ind[3, a["mb"][tb], chunk[tb], stage[tb], a["seq"][tb]]
            t0 = np.where(ri >= 0, start[np.maximum(ri, 0)], start[tb])
            times += [t0, end[tb]]
            deltas += [unit * (1.0 - frs[chunk[tb]]),
                       -unit * (1.0 - frs[chunk[tb]])]
            devs += [dev[stage[tb], chunk[tb]], dev[stage[tb], chunk[tb]]]
        times = np.concatenate(times)
        deltas = np.concatenate(deltas)
        devs = np.concatenate(devs)
        peaks = []
        for d in range(self.P):
            m_ = devs == d
            o = np.lexsort((deltas[m_], times[m_]))
            run = np.cumsum(deltas[m_][o])
            peaks.append(float(run.max(initial=0.0)))
        return peaks if per_stage else max(peaks)

    def warmup_cooldown_bubbles(self, stage: Optional[int] = None):
        """Idle intervals on a device before its first B-of-last-chunk
        cooldown task etc. — used by the Chronos-Offload planner.
        Returns list of (t0, t1) idle gaps on the device (the ``stage``
        argument names a device; they coincide for the interleaved
        placement).  Gap detection runs on the exact integer half-grain
        lattice — no float slop."""
        d = self.P - 1 if stage is None else stage
        ts = self.device_tasks(d)
        gaps = []
        for a, bb in zip(ts, ts[1:]):
            if to_half(bb.start) > to_half(a.end):
                gaps.append((a.end, bb.start))
        return gaps


def retime_with_comm(sched: Schedule, tc: float,
                     sync: bool = False) -> Schedule:
    """Re-simulate start times with a P2P latency ``tc`` (grains) on every
    device-*crossing* dependency edge, preserving each device's task
    order.  Under the interleaved placement every cross-stage edge
    crosses devices (the pre-placement behavior); under a V-shape
    placement the chunk hops are device-local and pay no latency.

    ``sync=False`` (default) models fully-asynchronous P2P (an asynchronous
    send/receive): latency delays only the consumer.  ``sync=True``
    reproduces the paper's accounting, where each send/receive blocks the
    stage for ``tc`` (mainstream-framework synchronous P2P): every task
    with a device-crossing input or output is lengthened by ``tc`` per
    edge.  Under sync the paper's result emerges: chronos with v chunks
    pays ~v x the 1F1B P2P bubble; under async chronos hides P2P better
    than 1F1B.
    """
    P, v, ns = sched.P, sched.v, sched.n_seq
    rcs = sched.r_chunks()
    n_total = len(sched.tasks)
    a = sched._arrays()
    kind, mb, chunk, stage, seq = (a["kind"], a["mb"], a["chunk"],
                                   a["stage"], a["seq"])
    ind, dev = a["ind"], a["dev"]
    recomp_a, dur_a = a["recomp"], a["dur"]
    my_dev = dev[stage, chunk]

    # ---- precompute dependency arrays: for each task, a padded list of
    # (dep index, +tc if device-crossing, applies-at-grad-needed) ----
    dep_idx = [[] for _ in range(n_total)]
    dep_tc = [[] for _ in range(n_total)]
    dep_g = [[] for _ in range(n_total)]

    def add_deps(mask, idx_arr, prod_s, prod_c, is_g, local=False):
        for i in np.flatnonzero(mask):
            j = idx_arr[i]
            assert j >= 0, \
                f"missing dependency for {sched.tasks[i].key()}"
            dep_idx[i].append(int(j))
            dep_tc[i].append(0.0 if local or dev[prod_s[i], prod_c[i]]
                             == my_dev[i] else tc)
            dep_g[i].append(is_g)

    is_f, is_b = kind == 0, kind == 1
    is_w, is_r = kind == 2, kind == 3
    in_rcs = np.isin(chunk, list(rcs)) if rcs else np.zeros(n_total, bool)
    sm1, cm1 = np.maximum(stage - 1, 0), np.maximum(chunk - 1, 0)
    sp1, cp1 = np.minimum(stage + 1, P - 1), np.minimum(chunk + 1, v - 1)
    qm1, qp1 = np.maximum(seq - 1, 0), np.minimum(seq + 1, ns - 1)
    pl_P1 = np.full(n_total, P - 1)
    pl_0 = np.zeros(n_total, np.int64)
    add_deps(is_f & (stage > 0), ind[0, mb, chunk, sm1, seq], sm1, chunk,
             False)
    add_deps(is_f & (stage == 0) & (chunk > 0),
             ind[0, mb, cm1, P - 1, seq], pl_P1, cm1, False)
    add_deps(is_f & (seq > 0), ind[0, mb, chunk, stage, qm1], stage,
             chunk, False, local=True)
    add_deps(is_w, ind[1, mb, chunk, stage, seq], stage, chunk, False,
             local=True)
    add_deps(is_r, ind[0, mb, chunk, stage, seq], stage, chunk, False,
             local=True)
    add_deps(is_b, ind[0, mb, chunk, stage, seq], stage, chunk, False,
             local=True)
    add_deps(is_b & in_rcs, ind[3, mb, chunk, stage, seq], stage, chunk,
             False, local=True)
    add_deps(is_b & (stage < P - 1), ind[1, mb, chunk, sp1, seq], sp1,
             chunk, True)
    add_deps(is_b & (stage == P - 1) & (chunk < v - 1),
             ind[1, mb, cp1, 0, seq], pl_0, cp1, True)
    add_deps(is_b & (stage == P - 1) & (chunk == v - 1),
             ind[0, mb, chunk, stage, seq], stage, chunk, True,
             local=True)
    add_deps(is_b & (seq < ns - 1), ind[1, mb, chunk, stage, qp1], stage,
             chunk, True, local=True)

    # sync mode: device-crossing inputs + outputs lengthen the task
    n_cross = np.array([sum(1 for t_ in tcs if t_ > 0)
                        for tcs in dep_tc], np.int64)
    out_s = np.where(is_f, sp1, sm1)
    out_s = np.where(is_f & (stage == P - 1), 0, out_s)
    out_s = np.where(is_b & (stage == 0), P - 1, out_s)
    out_c = np.where(is_f & (stage == P - 1), cp1,
                     np.where(is_b & (stage == 0), cm1, chunk))
    has_out = (is_f & ((stage < P - 1) | (chunk < v - 1))) | \
        (is_b & ((stage > 0) | (chunk > 0)))
    out_c_dev = dev[out_s, out_c]
    n_cross = n_cross + (has_out & (out_c_dev != my_dev)).astype(np.int64)
    extra_a = tc * n_cross if sync else np.zeros(n_total)

    # ---- event-driven replay preserving each device's task order ----
    order = {d: [i for i in np.lexsort((a["start"],))
                 if my_dev[i] == d] for d in range(P)}
    done = np.zeros(n_total, bool)
    done_t = np.zeros(n_total)
    new_start = np.zeros(n_total)
    ptr = {d: 0 for d in range(P)}
    free = {d: 0.0 for d in range(P)}
    placed = 0
    progressed = True
    while placed < n_total:
        progressed = False
        for d in range(P):
            lst = order[d]
            while ptr[d] < len(lst):
                i = lst[ptr[d]]
                di = dep_idx[i]
                if di and not done[di].all():
                    break
                es = g = 0.0
                for j, tcj, gj in zip(di, dep_tc[i], dep_g[i]):
                    t_ = done_t[j] + tcj
                    if gj:
                        g = max(g, t_)
                    else:
                        es = max(es, t_)
                start = max(free[d], es, g - recomp_a[i])
                new_start[i] = start
                done_t[i] = start + dur_a[i] + extra_a[i]
                done[i] = True
                free[d] = done_t[i]
                ptr[d] += 1
                placed += 1
                progressed = True
        if not progressed and placed < n_total:
            raise RuntimeError(
                f"deadlock retiming {sched.name}: placed "
                f"{placed}/{n_total}")
    new_tasks = [dataclasses.replace(t, start=float(new_start[i]),
                                     dur=t.dur + float(extra_a[i]),
                                     comm=t.comm + float(extra_a[i]))
                 for i, t in enumerate(sched.tasks)]
    out = dataclasses.replace(
        sched, tasks=sorted(new_tasks,
                            key=lambda t: (t.start, t.stage)))
    out.meta = dict(sched.meta, tc=tc)
    return out


def comm_calibration(sched: Schedule, tc: float) -> Dict[str, float]:
    """Predicted makespans (grains) of ``sched`` under the three wire
    models the executor can realize: ``zero`` (free communication, the
    compute floor), ``sync`` (each device-crossing edge blocks its
    producer/consumer for ``tc`` — the in-tick synchronous exchange),
    and ``async`` (latency delays only the consumer — the
    double-buffered overlapped exchange, which hides ``tc`` behind the
    next tick's compute).

    Calibrate against a measurement by scaling with a measured sync
    step: ``scale = measured_sync / cal['sync']`` turns the async
    prediction into wall-clock (``chip_smoke.py``'s train-ranks phase
    prints the scaled predictions beside the measured steps)."""
    return {"zero": retime_with_comm(sched, 0.0).total_time(),
            "sync": retime_with_comm(sched, tc, sync=True).total_time(),
            "async": retime_with_comm(sched, tc, sync=False).total_time()}


def _dep_keys(t: Task, P: int, v: int,
              r_chunks: FrozenSet[int] = frozenset(), n_seq: int = 1):
    q = t.seq
    if t.kind == F:
        deps = []
        if t.stage > 0:
            deps.append((F, t.mb, t.chunk, t.stage - 1, q))
        elif t.chunk > 0:
            deps.append((F, t.mb, t.chunk - 1, P - 1, q))
        if q > 0:
            deps.append((F, t.mb, t.chunk, t.stage, q - 1))
        return deps
    if t.kind == W:
        return [(B, t.mb, t.chunk, t.stage, q)]
    if t.kind == R:
        return [(F, t.mb, t.chunk, t.stage, q)]
    deps = [(F, t.mb, t.chunk, t.stage, q)]
    if t.chunk in r_chunks:
        deps.append((R, t.mb, t.chunk, t.stage, q))
    if q < n_seq - 1:
        deps.append((B, t.mb, t.chunk, t.stage, q + 1))
    if t.stage < P - 1:
        deps.append((B, t.mb, t.chunk, t.stage + 1, q))
    elif t.chunk < v - 1:
        deps.append((B, t.mb, t.chunk + 1, 0, q))
    return deps
