"""Sequence-chunked schedule generators (Seq1F1B family; own copy of
``repro/seqpipe/schedules.py``).

Every microbatch splits into ``n_seq`` causally-ordered sequence chunks;
the scheduling unit becomes (mb, layer-chunk, stage, seq) and one grain
is T_fwd/(v*P*n_seq).  Units are modeled with uniform grain durations —
the runtime balances per-chunk token counts so causal-attention cost is
(approximately) equal across chunks, the Seq1F1B/SlimPipe workload-
balance assumption.

Dependency structure beyond the classic four-coordinate rules
(:mod:`repro_torch.core.schedule`): forwards of a microbatch run in ascending
seq order on each stage (KV prefix hand-off) and backwards in
*descending* seq order (dKV accumulation), so the backward release
order within a microbatch is the reverse of its forward arrival order.

- ``seq1f1b``: 1F1B over sequence-chunk units.  Warm-up depth grows
  from 1F1B's ``P - s`` to ``P - s - 1 + n_seq`` (the first backward
  needs the whole first microbatch forwarded), so stage-0 peak
  activation is ``(P - 1 + n_seq)/(P * n_seq)`` of m_a — ~1/n_seq of
  1F1B's — while the bubble ratio *improves* (same (P-1)-grain ramps
  amortized over m*n_seq units).  ``split=True`` additionally splits
  each backward into the 1-grain input-gradient ``B`` plus a deferred
  1-grain weight-gradient ``W`` (ZB-H1 composition).

- ``chronos_seq``: the §4.1 chronos periodic slot classes over units.
  Construction: build ``chronos(P, m*n_seq, v)`` (or the
  ``chronos_recomp`` greedy packing when ``recomp_chunks > 0``), then
  (a) relabel forward unit ``u`` as (mb=u//n_seq, seq=u%n_seq), and
  (b) shift the whole B/R phase later by ``(n_seq-1)`` steady-state
  cycles and relabel backward slot ``β`` as
  (mb=β//n_seq, seq=n_seq-1-β%n_seq).  Shifting by whole cycles
  preserves the periodic class disjointness (no overlap is possible),
  and the reversed in-group assignment satisfies both the dKV-carry
  order and the own-forward dependency — see the inline proof sketch in
  ``_seqify``.  Temporal locality of the shallow chunks (the chronos
  memory profile) is preserved per unit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.schedule import (B, F, Schedule, Task, W,
                                 retime_with_comm)

FWD, BWD = 1.0, 2.0
BWD_IN, BWD_W = 1.0, 1.0


# ---------------------------------------------------------------------------
# seq1f1b
# ---------------------------------------------------------------------------

def seq1f1b(P: int, m: int, n_seq: int = 2, split: bool = False) -> Schedule:
    """1F1B over sequence-chunk units (Seq1F1B, arXiv 2406.03488).

    ``split=True`` composes the ZB-H1 split backward: ``B`` shrinks to
    the 1-grain input-gradient step and deferred ``W`` tasks fill the
    cool-down, at the same (already 1/n_seq-reduced) peak activation.
    """
    assert n_seq >= 1
    U = m * n_seq

    def fu(u):                      # u-th forward unit -> (mb, seq)
        return u // n_seq, u % n_seq

    def bu(u):                      # u-th backward unit -> (mb, seq)
        return u // n_seq, n_seq - 1 - (u % n_seq)

    tasks: List[Task] = []
    for s in range(P):
        # first backward (mb 0, seq n_seq-1) needs the whole first
        # microbatch forwarded through the pipe: warm-up deepens by
        # n_seq - 1 units relative to classic 1F1B.
        warm = min(P - s - 1 + n_seq, U)
        order = [(F,) + fu(i) for i in range(warm)]
        nf, nb, nw = warm, 0, 0
        if split:
            while nb < U:
                order.append((B,) + bu(nb)); nb += 1
                if nf < U:
                    order.append((F,) + fu(nf)); nf += 1
                elif nw < nb:
                    order.append((W,) + bu(nw)); nw += 1
            while nw < U:
                order.append((W,) + bu(nw)); nw += 1
        else:
            while nf < U or nb < U:
                if nb < U:
                    order.append((B,) + bu(nb)); nb += 1
                if nf < U:
                    order.append((F,) + fu(nf)); nf += 1
        t = 0.0
        for kind, i, q in order:
            dur = FWD if kind == F else \
                ((BWD_IN if kind == B else BWD_W) if split else BWD)
            tasks.append(Task(kind, i, 0, s, t, dur, seq=q))
            t += dur
    sched = Schedule(f"seq1f1b(s={n_seq}{',zb' if split else ''})",
                     P, 1, m, FWD, BWD_IN if split else BWD, tasks,
                     w=BWD_W if split else 0.0, n_seq=n_seq)
    sched = retime_with_comm(sched, 0.0)
    sched.check()
    return sched


# ---------------------------------------------------------------------------
# chronos_seq
# ---------------------------------------------------------------------------

def _seqify(base: Schedule, m: int, n_seq: int, cyc: float,
            name: str) -> Schedule:
    """Relabel a unit schedule (built with ``m * n_seq`` microbatches)
    into a sequence-chunked one.

    Forward unit ``u`` becomes (mb=u//n_seq, seq=u%n_seq) at its
    original time.  Backward-phase tasks (B, R, W) at unit slot ``β``
    become (mb=β//n_seq, seq=n_seq-1-β%n_seq) shifted ``(n_seq-1)*cyc``
    later.  Validity sketch (``Schedule.check`` re-verifies exactly):

    - occupancy: F and B/R slots live in disjoint periodic classes mod
      the steady-state cycle; shifting by whole cycles preserves the
      classes, so no overlap can appear;
    - dKV carry: slot β-1 (one cycle earlier) holds seq q+1 of the same
      microbatch — the descending-seq order is satisfied per stage;
    - own forward: slot β's time is >= F(β).end + shift in the base
      construction, and the relabeled unit's forward index
      ``mb*n_seq + q = β + (n_seq-1) - 2*(n_seq-1-q) <= β + n_seq-1``
      ends exactly ``(idx - β)`` cycles after F(β) — always within the
      shift budget;
    - cross-stage B edges connect equal β on adjacent stages, exactly
      as in the base schedule.
    """
    shift = (n_seq - 1) * cyc
    tasks: List[Task] = []
    for t in sorted(base.tasks, key=lambda t: (t.start, t.stage)):
        if t.kind == F:
            tasks.append(dataclasses.replace(
                t, mb=t.mb // n_seq, seq=t.mb % n_seq))
        else:
            # B and R of the same unit share the slot index; R precedes
            # its B back-to-back, so key the counter on the B only and
            # let R reuse its unit's mapping via t.mb (identical units).
            u = t.mb
            tasks.append(dataclasses.replace(
                t, mb=u // n_seq, seq=n_seq - 1 - (u % n_seq),
                start=t.start + shift))
    sched = Schedule(name, base.P, base.v, m, base.f, base.b, tasks,
                     stored_frac=dict(base.stored_frac),
                     meta=dict(base.meta, n_seq=n_seq), w=base.w,
                     n_seq=n_seq)
    sched.check()
    return sched


def chronos_seq(P: int, m: int, v: int = 2, n_seq: int = 2,
                rho: float = 1.0, recomp_chunks: int = 0) -> Schedule:
    """Chronos-Pipe slot classes composed with sequence chunking.

    ``recomp_chunks > 0`` composes Chronos-Recomp: the shallowest
    chunks replay from their boundary checkpoint via explicit per-unit
    ``R`` tasks (the greedy §4.2 packing over units)."""
    assert n_seq >= 1
    from repro_torch.core import schedules as S     # late: avoid import cycle
    if recomp_chunks > 0:
        base = S.chronos_recomp(P, m * n_seq, v, rho=rho,
                                recomp_chunks=recomp_chunks)
        cyc = base.meta["cycle"]
        name = (f"chronos-seq(v={v},s={n_seq},"
                f"rho={rho},rc={recomp_chunks})")
    else:
        base = S.chronos(P, m * n_seq, v)
        cyc = float(3 * v)
        name = f"chronos-seq(v={v},s={n_seq})"
    return _seqify(base, m, n_seq, cyc, name)


# ---------------------------------------------------------------------------
# forward_only: inference-serving derivation
# ---------------------------------------------------------------------------

def forward_only(sched: Schedule) -> Schedule:
    """Strip a schedule to its forward tasks (inference prefill).

    Serving needs no backward pass: a prompt streams through the P
    stages as ``n_seq`` causally-ordered sequence chunks, each stage
    appending to the microbatch's KV ring and handing the boundary
    activation down.  Dropping every B/W/R task from a seq-chunked
    schedule leaves a dependency-closed forward DAG (F tasks only ever
    depend on F tasks: prev stage, prev layer-chunk hop, prev seq
    chunk), which ``Schedule.check`` re-verifies.  Task times keep
    their training-schedule values; ``build_task_table`` re-times by
    topological tick assignment, so the gaps left by removed backwards
    compress away.
    """
    tasks = [t for t in sched.tasks if t.kind == F]
    out = dataclasses.replace(
        sched, name=f"{sched.name}+fwd_only", tasks=tasks, w=0.0,
        stored_frac={}, meta=dict(sched.meta, fwd_only=True))
    out.check()
    return out


def register(registry: Dict) -> None:
    registry["seq1f1b"] = seq1f1b
    registry["chronos_seq"] = chronos_seq
