"""V-shape controllable-memory schedule family (Qi et al., *Pipeline
Parallelism with Controllable Memory*, 2024; own copy of
``repro/core/vshape.py``).

All three generators run ``v = 2`` layer chunks under the
:class:`~repro_torch.core.placement.VShapePlacement` fold-back — device ``d``
holds layer-blocks ``d`` and ``2P-1-d``, the mid-network hop and the
backward hop are device-local — with the split backward of the
zero-bubble family (the ``W`` task kind: ``B`` is the 1-grain
input-gradient step that releases the activation, ``W`` the deferred
1-grain weight-gradient).  Every device owns exactly
``2F + 2B + 2W = 6`` grains of work per microbatch, so the steady-state
cycle is 6 grains and the family differs only in how far forwards run
*ahead* of backwards — the paper's controllable-memory axis:

- ``v_min``  — closed-form just-in-time construction: each microbatch's
  6 per-device passes are as tight as the dependency chains allow
  (repeating unit ``F·F·B·W·B·W``).  The two blocks a device hosts have
  complementary *steady-state* lifetimes (``4P-2d`` and ``2d+2`` grains
  against the 6-grain cycle), so in steady state every device holds
  ``(4P+2)/6`` in-flight units — ``~1/3`` of 1F1B's m_a, uniform
  across devices (exactly 0.375, uniform, at P=8) — at the price of
  the longest warm-up ramp of the family.  At small depths the
  warm-up/cool-down transients dominate the steady state and the
  measured peak rises to ``v_half``'s ``ceil(P/2)/P`` level (0.5 at
  P∈{2,4,6}, 2/3 at P=3); size memory budgets from
  ``peak_activation()``, not the asymptote.
- ``v_half`` — greedy eager-forward construction admitting at most
  ``ceil(P/2)`` microbatches past the deep chunk's backward: peak
  exactly ``ceil(P/2)/P`` of 1F1B's with a warm-up ramp roughly half
  of ``v_min``'s.
- ``v_zb``   — the same construction at ``P`` microbatches in flight:
  1F1B-level peak activation with the smallest bubble of the family —
  the warm-up packs down to the ideal ZB-H1 ``(P-1)(f+b-w)`` idle.

Construction notes.  ``v_min`` places F/B tasks on exact periodic
half-grain classes (mod 6): ``F0`` at ``s + 6i``, ``F1`` at
``P + s + 6i``, ``B1`` at ``3P-1-s + δ + 6i``, ``B0`` at
``4P-1-s + δ + 6i`` in stage coordinates, with ``δ = 2`` when
``P ≡ 0 (mod 3)`` (the only case where the backward classes would
collide with the forward classes mod 6 — all other pairwise class
differences are odd).  Deferred ``W`` tasks then fill the free residues
earliest-fit, exactly like ``chronos_zb``'s gap filler.  ``v_half`` /
``v_zb`` are event-driven list schedules (priority ``B > F > W``,
deeper chunk first) with the admission gate
``F(i, chunk 0, stage 0) <- B(i - cap, chunk 0, stage 0)`` — the
controllable in-flight cap.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core.placement import VShapePlacement, get_placement
from repro_torch.core.schedule import (B, F, Schedule, Task, W, from_half,
                                       to_half)

FWD = 1.0
BWD_IN, BWD_W = 1.0, 1.0     # split backward: input-grad + weight-grad
CYCLE = 6                    # 2F + 2B + 2W grains per microbatch/device


def _fill_w(P: int, m: int, fb_tasks: List[Task],
            pl: VShapePlacement) -> List[Task]:
    """Place one deferred W per B earliest-fit into the idle gaps of
    each device (same algorithm as ``chronos_zb``); the timeline is
    open-ended past the last F/B task."""
    wdh = to_half(BWD_W)
    out: List[Task] = []
    for d in range(P):
        occ: List[Tuple[int, int]] = []
        pend: List[Tuple] = []          # (ready half, chunk, stage, mb)
        for t in fb_tasks:
            if pl.device(t.stage, t.chunk) != d:
                continue
            h0 = to_half(t.start)
            occ.append((h0, h0 + to_half(t.dur)))
            if t.kind == B:
                pend.append((h0 + to_half(t.dur), t.chunk, t.stage, t.mb))
        occ.sort()
        gaps: List[List] = []
        cur = 0
        for (a, b_) in occ:
            if a > cur:
                gaps.append([cur, a])
            cur = max(cur, b_)
        gaps.append([cur, None])                # open tail
        pend.sort()
        for (ready, c, s, mb) in pend:
            for g in gaps:
                hi = g[1]
                lo = max(g[0], ready)
                if hi is not None and hi - lo < wdh:
                    continue
                out.append(Task(W, mb, c, s, from_half(lo), BWD_W))
                pos = gaps.index(g)
                g[1] = lo                       # left remnant [g0, lo)
                if hi is None or hi - (lo + wdh) > 0:
                    gaps.insert(pos + 1, [lo + wdh, hi])
                if g[1] - g[0] <= 0:
                    gaps.remove(g)
                break
    return out


def v_min(P: int, m: int) -> Schedule:
    """Memory-minimal V-shape schedule: ~1/3 of 1F1B's peak in steady
    state (see the module docstring for the small-P transient caveat).

    Closed form (stage coordinates; δ handles the ``P % 3 == 0``
    residue collision, see module docstring)::

        F(i,0,s) @ s + 6i          B(i,1,s) @ 3P-1-s + δ + 6i
        F(i,1,s) @ P + s + 6i      B(i,0,s) @ 4P-1-s + δ + 6i

    Every chain is exact: the mid-network hop (F0 stage P-1 -> F1 stage
    0) and the backward hop (B1 stage 0 -> B0 stage P-1) land on the
    same device back-to-back.
    """
    assert P >= 2 and m >= 1
    pl = get_placement("vshape", P, 2)
    delta = 2 if P % 3 == 0 else 0
    fb: List[Task] = []
    for i in range(m):
        base = CYCLE * i
        for s in range(P):
            fb.append(Task(F, i, 0, s, base + s, FWD))
            fb.append(Task(F, i, 1, s, base + P + s, FWD))
            fb.append(Task(B, i, 1, s, base + 3 * P - 1 - s + delta,
                           BWD_IN))
            fb.append(Task(B, i, 0, s, base + 4 * P - 1 - s + delta,
                           BWD_IN))
    tasks = fb + _fill_w(P, m, fb, pl)
    sched = Schedule(f"v-min(P={P})", P, 2, m, FWD, BWD_IN, tasks,
                     w=BWD_W, placement=pl,
                     meta={"family": "vshape", "delta": delta})
    sched.check()
    return sched


def _vshape_greedy(P: int, m: int, cap: int, name: str,
                   release_chunk: int = 1) -> Schedule:
    """Eager-forward V-shape list schedule with an in-flight admission
    cap (the controllable-memory knob): priorities ``B > F > W``,
    deeper chunk first, one grain per task.

    ``release_chunk`` picks the admission gate — microbatch ``i`` waits
    for ``B(i - cap, release_chunk, stage 0)``.  Chunk 1 (default)
    releases when the deep chunk's backward has drained: peak
    activation lands at exactly ``cap/P`` of m_a.  Chunk 0 releases
    only after the *full* backward drain — the extra ``~P`` grains of
    slack let the warm-up pack completely, which is what ``v_zb`` uses
    to reach the ideal ``(P-1)(f+b-w)`` zero-bubble ramp."""
    assert P >= 2 and m >= 1 and cap >= 1
    pl = get_placement("vshape", P, 2)
    deps: Dict[Tuple, List[Tuple]] = {}
    for i in range(m):
        for c in (0, 1):
            for s in range(P):
                fk = (F, i, c, s, 0)
                bk = (B, i, c, s, 0)
                dl: List[Tuple] = []
                if s > 0:
                    dl.append((F, i, c, s - 1, 0))
                elif c == 1:
                    dl.append((F, i, 0, P - 1, 0))   # device-local hop
                elif i >= cap:
                    # admission gate: at most ``cap`` microbatches in
                    # flight past the release point
                    dl.append((B, i - cap, release_chunk, 0, 0))
                deps[fk] = dl
                bl = [fk]                            # own forward
                if s < P - 1:
                    bl.append((B, i, c, s + 1, 0))
                elif c == 0:
                    bl.append((B, i, 1, 0, 0))       # device-local hop
                deps[bk] = bl
                deps[(W, i, c, s, 0)] = [bk]
    device_of = {k: pl.device(k[3], k[2]) for k in deps}
    succ: Dict[Tuple, List[Tuple]] = {k: [] for k in deps}
    ndep = {}
    for k, dl in deps.items():
        ndep[k] = len(dl)
        for dk in dl:
            succ[dk].append(k)
    ready_time: Dict[Tuple, int] = {}
    ready_dev: List[set] = [set() for _ in range(P)]
    for k, n in ndep.items():
        if n == 0:
            ready_time[k] = 0
            ready_dev[device_of[k]].add(k)
    prio = {B: 0, F: 1, W: 2}
    free = [0] * P
    tasks: List[Task] = []
    n_done, n_total, t = 0, len(deps), 0
    while n_done < n_total:
        for d in range(P):
            if free[d] > t or not ready_dev[d]:
                continue
            cands = [k for k in ready_dev[d] if ready_time[k] <= t]
            if not cands:
                continue
            k = min(cands, key=lambda k: (prio[k[0]], k[1], -k[2]))
            ready_dev[d].remove(k)
            tasks.append(Task(k[0], k[1], k[2], k[3], float(t), 1.0))
            end = t + 1
            free[d] = end
            n_done += 1
            for sk in succ[k]:
                ready_time[sk] = max(ready_time.get(sk, 0), end)
                ndep[sk] -= 1
                if ndep[sk] == 0:
                    ready_dev[device_of[sk]].add(sk)
        t += 1
    sched = Schedule(name, P, 2, m, FWD, BWD_IN, tasks, w=BWD_W,
                     placement=pl, meta={"family": "vshape", "cap": cap})
    sched.check()
    return sched


def v_half(P: int, m: int) -> Schedule:
    """Half-of-1F1B-memory V-shape schedule: eager forwards under a
    ``ceil(P/2)`` in-flight cap released at the deep chunk's backward —
    peak activation exactly ``ceil(P/2)/P`` of m_a with a bubble
    between ``v_min``'s and ``v_zb``'s."""
    return _vshape_greedy(P, m, -(-P // 2), f"v-half(P={P})",
                          release_chunk=1)


def v_zb(P: int, m: int) -> Schedule:
    """Zero-bubble-leaning V-shape schedule: eager forwards under a
    ``P`` in-flight cap released at the full backward drain —
    1F1B-level peak activation (exactly 1.0 m_a), the smallest bubble
    of the V family: the ramp packs down to the ideal ZB-H1
    ``(P-1)(f+b-w)`` idle (composes the split-backward W tasks)."""
    return _vshape_greedy(P, m, P, f"v-zb(P={P})", release_chunk=0)


def register(registry: Dict) -> None:
    registry["v_min"] = v_min
    registry["v_half"] = v_half
    registry["v_zb"] = v_zb
