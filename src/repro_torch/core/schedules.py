"""Pipeline schedule generators (own copy of ``repro/core/schedules.py``).

All generators return a validated :class:`Schedule` in grain time
(f = 1 grain forward, b = 2 grains backward per (stage, chunk) block,
the paper's T_bwd = 2 T_fwd assumption).  Chronos schedules implement the
paper's constructions:

- ``chronos``      : §4.1 closed-form.  Forward chunk c on stage s occupies
                     the periodic slot class (s + 3c) mod 3v; backward
                     chunk c starts in class (3P+1-2s+3(v-1-c)) mod 3v.
                     These classes exactly pack the 3v-grain steady-state
                     cycle for every P and v (disjointness mod 3), and the
                     alignment gaps reproduce the paper's
                     T_fwd_interval = (3+6*ceil((P-3)/6)-P) and
                     T_bwd_interval = (3+6*ceil((2P-3)/6)-2P).
- ``chronos_recomp``: §4.2 closed-form for v=2 with full recompute of the
                     shallow chunk (7-grain cycle, chunk-2 forward gap
                     pattern g(s)=s+ceil(s/2), Appendix-A launch delay),
                     greedy periodic placement for other configs.
- ``chronos_zero2`` : §4.3 grouped chunk re-launches for micro-batch-
                     granularity DP collectives.

Split-backward (zero-bubble) family — the backward is split into a
1-grain input-gradient task ``B`` and a 1-grain deferred weight-gradient
task ``W`` (B + W = the fused 2-grain backward):

- ``zb_h1``     : the handcrafted ZB-H1 schedule (Qi et al., *Zero
                  Bubble Pipeline Parallelism* / *Pipeline Parallelism
                  with Controllable Memory*): 1F1B warm-up counts (same
                  peak activation), W tasks fill the cool-down bubbles.
- ``chronos_zb``: Chronos-Pipe with split backward — the periodic §4.1
                  slot classes are kept, each backward slot shrinks to
                  its input-gradient grain, and the freed grains plus
                  the warm-up/cool-down alignment bubbles are filled
                  with deferred W tasks.

All time arithmetic runs on an exact integer half-grain lattice
(:data:`repro_torch.core.schedule.HALF`); there is deliberately no float
epsilon anywhere in alignment or occupancy checks, so ``Schedule.check``
cannot flake on accumulated drift at large ``m``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.schedule import (B, F, HALF, R, Schedule, Task, W,
                                 from_half, retime_with_comm, to_half)

FWD, BWD = 1.0, 2.0
BWD_IN, BWD_W = 1.0, 1.0     # split backward: input-grad + weight-grad


def _align(t: float, cls: int, cyc: int) -> float:
    """Smallest time >= t in periodic slot class ``cls`` (mod ``cyc``),
    computed exactly in integer half-grains (no 1e-9 slop)."""
    th, ch, cyh = to_half(t), cls * HALF, cyc * HALF
    k = -((ch - th) // cyh)          # ceil((th - ch) / cyh)
    return from_half(ch + k * cyh)


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

def _quant_recomp(recomp: float) -> float:
    """Quantize a uniform-recompute time prefix up onto the half-grain
    lattice (the *memory* fraction keeps the exact value; only the
    modeled replay time rounds, so every constructed start/end stays
    an exact half-grain multiple)."""
    import math
    return math.ceil(recomp * FWD * HALF - 1e-12) / HALF


def gpipe(P: int, m: int, recomp: float = 0.0) -> Schedule:
    tasks = []
    rq = _quant_recomp(recomp)
    for i in range(m):
        for s in range(P):
            tasks.append(Task(F, i, 0, s, i + s, FWD))
    base = m + P  # after flush
    for j, i in enumerate(reversed(range(m))):
        for s in reversed(range(P)):
            tasks.append(Task(B, i, 0, s,
                              base + j * BWD + (P - 1 - s) * BWD,
                              BWD + rq, rq))
    sched = Schedule("gpipe", P, 1, m, FWD, BWD, tasks,
                     stored_frac={0: 1.0 - recomp})
    sched = retime_with_comm(sched, 0.0)
    sched.check()
    return sched


def onef1b(P: int, m: int, recomp: float = 0.0) -> Schedule:
    """1F1B (DAPPLE).  ``recomp`` in [0,1]: uniform recompute fraction
    (1F1B+R in the paper); adds recomp*FWD grains to every backward."""
    tasks = []
    rq = _quant_recomp(recomp)
    bdur = BWD + rq
    for s in range(P):
        warm = min(P - s, m)
        order = [(F, i) for i in range(warm)]
        nf, nb = warm, 0
        while nf < m or nb < m:
            if nb < m:
                order.append((B, nb)); nb += 1
            if nf < m:
                order.append((F, nf)); nf += 1
        t = 0.0
        for kind, i in order:
            if kind == F:
                tasks.append(Task(F, i, 0, s, t, FWD)); t += FWD
            else:
                tasks.append(Task(B, i, 0, s, t, bdur, rq))
                t += bdur
    # recompute fraction R discards R of the activations (recompute R of
    # the layers fully): stored fraction = 1 - R.
    sf = 1.0 - recomp
    sched = Schedule(f"1f1b{f'+R={recomp:.0%}' if recomp else ''}",
                     P, 1, m, FWD, BWD, tasks, stored_frac={0: sf})
    sched = retime_with_comm(sched, 0.0)
    sched.check()
    return sched


def interleaved(P: int, m: int, v: int) -> Schedule:
    """Megatron interleaved 1F1B (virtual pipeline).  Requires m % P == 0."""
    assert m % P == 0, "interleaved-1F1B needs microbatches % P == 0"
    total = m * v

    def fwd_unit(k):   # k-th forward unit -> (mb, chunk)
        grp, pos = divmod(k, P * v)
        chunk = pos // P
        mb = grp * P + pos % P
        return mb, chunk

    def bwd_unit(k):
        grp, pos = divmod(k, P * v)
        chunk = v - 1 - pos // P
        mb = grp * P + pos % P
        return mb, chunk

    tasks = []
    for s in range(P):
        warm = min(total, (P - s - 1) * 2 + (v - 1) * P)
        order = []
        nf = nb = 0
        for _ in range(warm):
            order.append((F,) + fwd_unit(nf)); nf += 1
        while nf < total or nb < total:
            # Megatron interleaved steady state: forward before backward
            if nf < total:
                order.append((F,) + fwd_unit(nf)); nf += 1
            if nb < total:
                order.append((B,) + bwd_unit(nb)); nb += 1
        t = 0.0
        for kind, mb, c in order:
            if kind == F:
                tasks.append(Task(F, mb, c, s, t, FWD)); t += FWD
            else:
                tasks.append(Task(B, mb, c, s, t, BWD)); t += BWD
    sched = Schedule(f"interleaved-1f1b(v={v})", P, v, m, FWD, BWD, tasks)
    sched = retime_with_comm(sched, 0.0)
    sched.check()
    return sched


# ---------------------------------------------------------------------------
# Chronos-Pipe (closed form, §4.1)
# ---------------------------------------------------------------------------

def chronos(P: int, m: int, v: int = 2) -> Schedule:
    cyc = 3 * v
    tasks = []
    idx: Dict = {}
    for i in range(m):
        base = cyc * i
        # forwards
        for c in range(v):
            for s in range(P):
                cls = (s + 3 * c) % cyc
                if c == 0 and s == 0:
                    t = float(base)
                elif s == 0:
                    dep = idx[(F, i, c - 1, P - 1, 0)].end
                    t = _align(dep, (0 + 3 * c) % cyc, cyc)
                else:
                    dep = idx[(F, i, c, s - 1, 0)].end
                    t = _align(dep, cls, cyc)
                tk = Task(F, i, c, s, t, FWD)
                idx[tk.key()] = tk
                tasks.append(tk)
        # backwards.  Classes anchor at the end of the last forward:
        # (P-1 + 3(v-1) + 1) mod 3v = P-3 mod 3v, then descend tightly
        # (-2 per stage) and hop +3 per chunk.  For v=2 this equals the
        # paper's (3P+1-2s) mod 6 classes.
        for c in reversed(range(v)):
            for s in reversed(range(P)):
                cls = (3 * P - 5 - 2 * s + 3 * (v - 1 - c)) % cyc
                if c == v - 1 and s == P - 1:
                    t = idx[(F, i, c, P - 1, 0)].end
                elif s == P - 1:
                    dep = idx[(B, i, c + 1, 0, 0)].end
                    t = _align(dep, cls, cyc)
                else:
                    dep = idx[(B, i, c, s + 1, 0)].end
                    t = _align(dep, cls, cyc)
                tk = Task(B, i, c, s, t, BWD)
                idx[tk.key()] = tk
                tasks.append(tk)
    sched = Schedule(f"chronos(v={v})", P, v, m, FWD, BWD, tasks)
    sched.check()
    return sched


# ---------------------------------------------------------------------------
# Chronos-Recomp (§4.2)
# ---------------------------------------------------------------------------

def chronos_recomp(P: int, m: int, v: int = 2, rho: float = 1.0,
                   recomp_chunks: int = 1) -> Schedule:
    """Recompute the ``recomp_chunks`` shallowest chunks with per-chunk
    recompute fraction ``rho``.  v=2, rho=1 uses the paper's closed form;
    other configs use greedy periodic placement.

    The replay is emitted as an explicit fourth task kind ``R``
    (``rho * f`` grains) immediately preceding the chunk's plain
    ``b``-grain backward on the same stage — the task-table compiler
    lowers it to a rematerialization tick with its own ring buffer, and
    the SPMD executor replays the forward from the stored boundary
    checkpoint (gradients bitwise-equal to the no-recompute path)."""
    return _chronos_greedy(P, m, v, rho, recomp_chunks)


def _chronos_greedy(P: int, m: int, v: int, rho: float,
                    recomp_chunks: int) -> Schedule:
    """Greedy periodic placement: place microbatch-0 tasks in dependency
    order onto per-stage periodic occupancy masks (period = steady-state
    cycle); all other microbatches are cycle-shifted copies.  If perfect
    packing fails the cycle is inflated (honest steady-state bubble).

    All occupancy arithmetic is exact integer half-grains: the recompute
    extension ``rho * FWD`` is quantized onto the half-grain lattice, and
    interval overlap tests are integer comparisons (no epsilon)."""
    rext = round(rho * FWD * HALF) / HALF
    base_cyc_h = 3 * v * HALF + recomp_chunks * to_half(rext)

    def try_build(cyc_h: int, delays=()) -> Optional[Schedule]:
        """delays[c-1]: extra launch delay (grains) for chunk c's first F
        — the paper's Appendix-A round delay, generalized.  ``cyc_h`` is
        the steady-state cycle in half-grains."""
        occ: List[List] = [[] for _ in range(P)]   # int intervals mod cyc

        def fits(s, t0h, durh):
            a0 = t0h % cyc_h
            segs = [(a0, min(a0 + durh, cyc_h))]
            if a0 + durh > cyc_h:
                segs.append((0, a0 + durh - cyc_h))
            for (x0, x1) in segs:
                for (y0, y1) in occ[s]:
                    if x0 < y1 and y0 < x1:
                        return False
            return True

        def claim(s, t0h, durh):
            a0 = t0h % cyc_h
            occ[s].append((a0, min(a0 + durh, cyc_h)))
            if a0 + durh > cyc_h:
                occ[s].append((0, a0 + durh - cyc_h))

        def place(s, earliest_h, durh, horizon=6):
            th = earliest_h
            lim = earliest_h + horizon * cyc_h
            while th < lim:
                if fits(s, th, durh):
                    return th
                th += 1  # half-grain granularity
            return None

        idx: Dict = {}
        t0_tasks = []
        for c in range(v):
            for s in range(P):
                if c == 0 and s == 0:
                    dep = 0
                elif s == 0:
                    dep = to_half(idx[(F, 0, c - 1, P - 1, 0)].end)
                    if c - 1 < len(delays):
                        dep += delays[c - 1] * HALF
                else:
                    dep = to_half(idx[(F, 0, c, s - 1, 0)].end)
                th = place(s, dep, to_half(FWD))
                if th is None:
                    return None
                tk = Task(F, 0, c, s, from_half(th), FWD)
                idx[tk.key()] = tk
                t0_tasks.append(tk)
                claim(s, th, to_half(FWD))
        for c in reversed(range(v)):
            rec = rext if c < recomp_chunks else 0.0
            dur = BWD + rec
            durh, rech = to_half(dur), to_half(rec)
            for s in reversed(range(P)):
                if c == v - 1 and s == P - 1:
                    dep = to_half(idx[(F, 0, c, P - 1, 0)].end)
                elif s == P - 1:
                    dep = to_half(idx[(B, 0, c + 1, 0, 0)].end)
                else:
                    dep = to_half(idx[(B, 0, c, s + 1, 0)].end)
                # the recompute replay may start before the gradient
                # arrives (it only needs the boundary checkpoint)
                th = place(s, dep - rech, durh)
                if th is None or th + rech < dep:
                    th = place(s, dep, durh)
                if th is None:
                    return None
                if rech:
                    # explicit R task (replay) + plain backward, placed
                    # back-to-back as one occupancy block
                    rk = Task(R, 0, c, s, from_half(th), rec)
                    idx[rk.key()] = rk
                    t0_tasks.append(rk)
                    tk = Task(B, 0, c, s, from_half(th + rech), BWD)
                else:
                    tk = Task(B, 0, c, s, from_half(th), BWD)
                idx[tk.key()] = tk
                t0_tasks.append(tk)
                claim(s, th, durh)
        cyc = from_half(cyc_h)
        tasks = []
        for i in range(m):
            for tk in t0_tasks:
                tasks.append(dataclasses.replace(tk, mb=i,
                                                 start=tk.start + cyc * i))
        sf = {c: (1.0 - rho) if c < recomp_chunks else 1.0
              for c in range(v)}
        sched = Schedule(
            f"chronos+recomp(v={v},rho={rho},rc={recomp_chunks})",
            P, v, m, FWD, BWD, tasks, stored_frac=sf,
            meta={"cycle": cyc})
        sched.check()
        return sched

    import itertools
    cyc_h = base_cyc_h
    for _ in range(8):
        # prefer minimal launch delay at the nominal cycle before inflating
        # (the Appendix-A adjustment "does not impact the critical path").
        cands = sorted(itertools.product(range(0, base_cyc_h + 1),
                                         repeat=max(v - 1, 0)),
                       key=lambda d: sum(d))
        for delays in cands:
            out = try_build(cyc_h, delays)
            if out is not None:
                out.meta["delays"] = delays
                return out
        cyc_h += 1                       # inflate by half a grain
    raise RuntimeError(f"greedy chronos failed P={P} v={v} rho={rho}")


# ---------------------------------------------------------------------------
# ZeRO-2-compatible Chronos (§4.3)
# ---------------------------------------------------------------------------

def chronos_zero2(P: int, m: int, v: int = 2, group: int = 2) -> Schedule:
    """Grouped chunk re-launches (Fig. 7): per stage, ``group`` consecutive
    microbatches' same-(kind, chunk) tasks run back-to-back, so each DP
    reduce-scatter / all-gather covers ``group`` microbatches and can
    overlap with the adjacent same-chunk task — ZeRO-2 at micro-batch
    granularity without Breadth-First-PP's activation blowup.

    Construction: take the chronos per-stage slot orders, transpose each
    ``group``-cycle window from [A1 B1 C1 D1 | A2 B2 C2 D2] to
    [A1 A2 B1 B2 C1 C2 D1 D2], then retime respecting dependencies.
    Lifespans change by O(group) grains, so peak activation stays within
    ~one block of chronos ("minimal impact on activation storage")."""
    assert m % group == 0
    base = chronos(P, m, v)
    tasks = []
    for s in range(P):
        order = base.stage_tasks(s)
        streams: Dict = {}            # (kind, chunk) -> mb-ordered tasks
        for t in order:
            streams.setdefault((t.kind, t.chunk), []).append(t)
        emitted = {k: 0 for k in streams}
        reordered: List[Task] = []
        for t in order:
            k = (t.kind, t.chunk)
            i = emitted[k]
            mb_group = t.mb // group
            if i > t.mb:
                continue              # already emitted with its group
            # emit the whole group of this stream consecutively
            while emitted[k] < min((mb_group + 1) * group, m):
                reordered.append(streams[k][emitted[k]])
                emitted[k] += 1
        for r, t in enumerate(reordered):
            tasks.append(dataclasses.replace(t, start=float(r)))
    sched = Schedule(f"chronos-zero2(v={v},g={group})", P, v, m, FWD, BWD,
                     tasks, meta={"group": group})
    sched = retime_with_comm(sched, 0.0)
    sched.check()
    return sched


# ---------------------------------------------------------------------------
# split-backward (zero-bubble) family
# ---------------------------------------------------------------------------

def zb_h1(P: int, m: int) -> Schedule:
    """ZB-H1 handcrafted split-backward schedule (Qi et al., *Zero Bubble
    Pipeline Parallelism*; the memory-controlled variant of *Pipeline
    Parallelism with Controllable Memory*).

    The fused 2-grain backward splits into a 1-grain input-gradient ``B``
    (unblocks the upstream stage, releases the activation) and a 1-grain
    deferred weight-gradient ``W``.  Warm-up forward counts match 1F1B,
    so peak activation is <= 1F1B's; in the cool-down each stage fills
    its former bubble with pending W tasks, shrinking the bubble from
    1F1B's (P-1)(f+b) grains toward (P-1)(f + b_in - w).
    """
    tasks = []
    for s in range(P):
        warm = min(P - s, m)
        order = [(F, i) for i in range(warm)]
        nf, nb, nw = warm, 0, 0
        while nb < m:
            order.append((B, nb)); nb += 1
            if nf < m:
                order.append((F, nf)); nf += 1
            elif nw < nb:
                order.append((W, nw)); nw += 1
        while nw < m:
            order.append((W, nw)); nw += 1
        t = 0.0
        for kind, i in order:
            dur = FWD if kind == F else (BWD_IN if kind == B else BWD_W)
            tasks.append(Task(kind, i, 0, s, t, dur))
            t += dur
    sched = Schedule("zb-h1", P, 1, m, FWD, BWD_IN, tasks, w=BWD_W)
    sched = retime_with_comm(sched, 0.0)
    sched.check()
    return sched


def chronos_zb(P: int, m: int, v: int = 2) -> Schedule:
    """Chronos-Pipe with split backward (beyond-paper hybrid).

    Keeps the §4.1 periodic slot classes — so temporal locality and the
    chronos peak-activation profile are untouched — but every fused
    2-grain backward shrinks to its 1-grain input-gradient ``B`` at the
    same slot, and the freed grains plus the warm-up/cool-down alignment
    bubbles absorb the deferred weight-gradient ``W`` tasks (each placed
    at the earliest idle slot at/after its own B's end).  Because every
    shrunk B frees exactly the grain a W needs, earliest-fit never
    extends the span: total time == ``chronos`` with strictly more of it
    spent on useful compute.
    """
    base = chronos(P, m, v)
    bih = to_half(BWD_IN)
    wdh = to_half(BWD_W)
    tasks: List[Task] = []
    for s in range(P):
        sts = base.stage_tasks(s)
        occ: List[tuple] = []            # occupied [h0, h1) half-grains
        pend: List[tuple] = []           # (B end half, mb, chunk)
        for t in sts:
            h0 = to_half(t.start)
            if t.kind == B:
                tasks.append(dataclasses.replace(t, dur=BWD_IN))
                occ.append((h0, h0 + bih))
                pend.append((h0 + bih, t.mb, t.chunk))
            else:
                tasks.append(t)
                occ.append((h0, h0 + to_half(t.dur)))
        occ.sort()
        # merged free gaps; the timeline is open-ended past the last task
        gaps: List[List[int]] = []
        cur = 0
        for (a, b_) in occ:
            if a > cur:
                gaps.append([cur, a])
            cur = max(cur, b_)
        gaps.append([cur, None])         # open tail
        pend.sort()
        for (ready, mb, c) in pend:
            for g in gaps:
                hi = g[1]
                lo = max(g[0], ready)
                if hi is not None and hi - lo < wdh:
                    continue
                tasks.append(Task(W, mb, c, s, from_half(lo), BWD_W))
                pos = gaps.index(g)
                g[1] = lo                # left remnant [g0, lo)
                if hi is None or hi - (lo + wdh) > 0:
                    gaps.insert(pos + 1, [lo + wdh, hi])
                if g[1] - g[0] <= 0:
                    gaps.remove(g)
                break
    sched = Schedule(f"chronos-zb(v={v})", P, v, m, FWD, BWD_IN, tasks,
                     w=BWD_W, meta=dict(base.meta, split_backward=True))
    sched.check()
    return sched


REGISTRY = {
    "gpipe": gpipe,
    "1f1b": onef1b,
    "interleaved": interleaved,
    "chronos": chronos,
    "chronos_recomp": chronos_recomp,
    "chronos_zero2": chronos_zero2,
    "zb_h1": zb_h1,
    "chronos_zb": chronos_zb,
}

# sequence-chunked generators (repro_torch.seqpipe) and the V-shape
# family (repro_torch.core.vshape) register themselves here; the imports
# are at module end so those modules only depend on the leaf IR modules
# (repro_torch.core.schedule / repro_torch.core.placement), never back on
# this one.


def get_schedule(name: str, P: int, m: int, **kw) -> Schedule:
    """Build a validated schedule from :data:`REGISTRY`.

    Fused-backward generators: ``gpipe``, ``1f1b`` (``recomp=``),
    ``interleaved`` (``v=``), ``chronos`` (``v=``), ``chronos_recomp``
    (``v=, rho=, recomp_chunks=``), ``chronos_zero2`` (``v=, group=``).
    Split-backward (B/W) generators: ``zb_h1`` (v=1) and ``chronos_zb``
    (``v=``) — their schedules carry the third task kind ``W`` and set
    ``Schedule.w``; the task-table compiler and SPMD runtime switch to
    the input-grad/weight-grad split automatically.
    Explicit-recompute schedules (``chronos_recomp``) carry the fourth
    task kind ``R`` (``F -> R -> B`` per rematerialized chunk); the
    task-table compiler shrinks their activation ring to the F->R
    window, adds an R->B remat ring, and the SPMD runtime replays under
    the boundary (the backward recomputes the chunk from it) with
    gradients bitwise-equal to the no-recompute path.
    Sequence-chunked generators (``repro_torch.seqpipe``): ``seq1f1b``
    (``n_seq=, split=``; v=1) and ``chronos_seq`` (``v=, n_seq=,
    rho=, recomp_chunks=``) — their tasks carry the fifth scheduling
    coordinate ``Task.seq`` with causal KV-prefix / dKV-carry deps, and
    the task-table compiler adds per-microbatch KV-carry + dKV rings.
    V-shape controllable-memory generators (``repro_torch.core.vshape``):
    ``v_min``, ``v_half``, ``v_zb`` (v=2, split backward) — their
    schedules carry a :class:`~repro_torch.core.placement.VShapePlacement`
    (device ``d`` hosts layer-blocks ``d`` and ``2P-1-d``; chunk hops
    are device-local), and the task-table compiler and the executor
    route payloads by placement-mapped device deltas.

    The authoritative generator list is generated from the registry —
    registered: {registry}.
    """
    if name not in REGISTRY:
        raise ValueError(
            f"unknown schedule {name!r}; registered schedules: "
            f"{', '.join(sorted(REGISTRY))}")
    return REGISTRY[name](P, m, **kw)


from repro_torch.core.vshape import register as _register_vshape  # noqa: E402
from repro_torch.seqpipe.schedules import \
    register as _register_seqpipe  # noqa: E402

_register_vshape(REGISTRY)
_register_seqpipe(REGISTRY)

# the generator list in the docstring is generated, not hand-written —
# it cannot drift from REGISTRY
if get_schedule.__doc__:            # (not under python -OO)
    get_schedule.__doc__ = get_schedule.__doc__.replace(
        "{registry}", ", ".join(f"``{n}``" for n in sorted(REGISTRY)))
