"""Schedule -> lockstep task table (own copy of
``repro/core/tasktable.py`` without its phase factorization).

The pipeline executor (:mod:`repro_torch.core.pipeline_runtime`) walks
the table tick by tick; at each tick every device column executes at
most one task (selected by its table row) and the boundary payloads it
produces move into their consumers' queue slots (forward shift,
backward shift, chunk hops).  The table compiler:

1. assigns each schedule task a tick = topological level that preserves
   each stage's order and gives every cross-stage payload at least one
   tick between production and consumption;
2. sizes the activation ring buffers per chunk from the schedule's
   max-in-flight counts (THIS is where Chronos-Pipe's memory saving
   becomes structural: the compiled buffers are smaller);
3. colors payload queues (arrival -> consumption intervals) so every
   transfer has a static slot.

Op codes: 0 idle | 1 fwd-mid | 2 fwd-first | 3 fwd-last (turnaround) |
          4 bwd-mid | 5 bwd-first | 6 bwd-last |
          7 wgrad-mid | 8 wgrad-first | 9 wgrad-last |
          10 remat-mid | 11 remat-first | 12 remat-last

The table is indexed by **device**, not stage: every column is one mesh
position along the pipeline axis, and the schedule's
:class:`~repro_torch.core.placement.Placement` decides which (stage, chunk)
task lands in which column.  Send codes name the *device delta* of the
payload's consumer (the placement maps stage-space edges to physical
routes):

Send codes: 0 none | 1 F down (d -> d+1) | 2 hop F (wrap P-1 -> 0) |
            3 B up (d -> d-1) | 4 hop B (wrap 0 -> P-1) |
            5 F up (d -> d-1) | 6 B down (d -> d+1) |
            7 F local (stays on device) | 8 B local

Under the interleaved placement only codes 0-4 appear (the legacy
routes); a V-shape placement uses 5-8 for the folded chunk (its forward
moves *up* the devices) and the device-local chunk hops, and never
wraps.  Receive slots are split per arrival channel (down / up / local)
so opposite-direction payloads of the same kind can land on one device
in the same tick; the wrap channels reuse the down (F at device 0) and
up (B at device P-1) columns, which those devices cannot otherwise
receive on.

Split-backward schedules (those carrying ``W`` tasks) compile the bwd
op codes as *input-gradient only* steps: the B tick computes dx, sends
it upstream, and stashes its residuals (boundary payload + upstream
gradient) into a W-stash ring; the matching wgrad tick (op 7-9) reads
the stash and accumulates the weight gradients.  ``wstash_depth`` sizes
that ring per chunk exactly like ``act_depth`` sizes the activation
ring — from the schedule's max B->W in-flight count.

Explicit-recompute schedules (those carrying ``R`` tasks, e.g.
``chronos_recomp``): for rematerialized chunks the activation stash
shrinks to *boundary payloads only* with an F->R lifetime — the remat
tick (op 10-12) reads the stored boundary checkpoint, replays the chunk
forward, and hands the payload off to a rematerialization ring
(``rmt_depth``, R->B lifetime) that the chunk's backward consumes.
``validate_table`` runs a FIFO-safety pass over both rings: a slot
written at F (resp. R) must stay live until its matching R (resp. B)
reads it.

Sequence-chunked schedules (``n_seq > 1``, e.g. ``seq1f1b`` /
``chronos_seq``): the stash unit becomes a (mb, seq) sequence-chunk
payload (1/n_seq of a boundary) and two new per-microbatch rings
appear: the KV-carry ring (``kv_depth``; prefix K/V handed from
F[mb,q-1] to F[mb,q] and replayed by every B; lifetime F[mb,0] ->
B[mb,0], FIFO by microbatch) and its twin dKV accumulation ring with
the same slots.  Backwards retire units in *reverse* seq order, so the
activation ring is no longer FIFO within a microbatch —
``mb % depth`` slot assignment is replaced by exact interval coloring
per stage, and ``validate_table`` switches from the FIFO check to a
general no-overwrite-while-live check over the colored slots.  W-stash
and remat rings stay FIFO in the *backward* unit order
``β = mb*n_seq + (n_seq-1-seq)`` (their writers and readers share it).

Forward-only schedules (``repro_torch.seqpipe.schedules.forward_only``,
inference prefill) compile without activation, W-stash or remat rings;
only the KV-carry ring remains, closing at the microbatch's last seq
chunk.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.placement import Placement
from repro_torch.core.schedule import B, F, R, Schedule, W, _dep_keys

(IDLE, FWD_MID, FWD_FIRST, FWD_LAST, BWD_MID, BWD_FIRST, BWD_LAST,
 WGT_MID, WGT_FIRST, WGT_LAST, RCP_MID, RCP_FIRST, RCP_LAST) = range(13)
(SEND_NONE, SEND_FWD, SEND_HOPF, SEND_BWD, SEND_HOPB,
 SEND_F_UP, SEND_B_DOWN, SEND_F_LOC, SEND_B_LOC) = range(9)

RECV_CHANNELS = ("dn", "up", "loc")


@dataclass
class TaskTable:
    P: int
    v: int
    m: int
    T: int                       # number of ticks
    op: np.ndarray               # [T, P] int32 (columns indexed by DEVICE)
    chunk: np.ndarray            # [T, P]
    mb: np.ndarray               # [T, P]
    src_slot: np.ndarray         # [T, P] queue slot read by this task (-1)
    act_slot: np.ndarray         # [T, P] boundary store/read slot (-1)
    send: np.ndarray             # [T, P] send code
    recv_f: Dict[str, np.ndarray]  # channel ("dn"|"up"|"loc") -> [T, P]
                                 # F-queue slot written this tick (-1);
                                 # wrap (hop) arrivals use "dn"
    recv_b: Dict[str, np.ndarray]  # same for B payloads; wraps use "up"
    w_slot: np.ndarray           # [T, P] W-stash slot: write at B, read at W
    r_slot: np.ndarray           # [T, P] remat-ring slot: write at R, read at B
    seq: np.ndarray              # [T, P] sequence-chunk index (0 if unused)
    kv_slot: np.ndarray          # [T, P] KV-carry/dKV ring slot (-1)
    fq_depth: int                # F payload queue depth
    bq_depth: int
    act_depth: Dict[int, int]    # chunk -> activation slots (F->R lifetime
                                 # for rematerialized chunks, F->B otherwise)
    wstash_depth: Dict[int, int] = dataclasses.field(default_factory=dict)
    rmt_depth: Dict[int, int] = dataclasses.field(default_factory=dict)
    name: str = ""
    # sequence chunking (repro_torch.seqpipe)
    n_seq: int = 1
    kv_depth: Dict[int, int] = dataclasses.field(default_factory=dict)
                                 # chunk -> KV-carry slots (per microbatch,
                                 # lifetime F[mb,0] -> B[mb,0])
    placement_name: str = "interleaved"
    #: delivery contract of the wire.  ``False``: a cross-device payload
    #: produced at tick t is in its queue slot before tick t+1 runs
    #: (synchronous in-tick exchange).  ``True``: the exchange is
    #: double-buffered — the payload is delivered DURING tick t+1
    #: (overlapping that tick's compute) and readable only from tick
    #: t+2, so every cross-device dependency is assigned a 2-tick gap.
    #: Device-local handoffs keep the 1-tick gap in both modes.
    overlap: bool = False

    @property
    def has_w(self) -> bool:
        return bool(self.wstash_depth)

    @property
    def has_r(self) -> bool:
        return bool(self.rmt_depth)

    @property
    def fwd_only(self) -> bool:
        """True for inference-prefill tables (no backward op anywhere):
        act slots stay -1 and the KV ring closes at the last seq chunk."""
        return not np.isin(self.op, B_OPS).any()

    def arrays(self):
        """Stacked int32 [T, P, 16].  Column order:
        op, chunk, mb, src_slot, act_slot, send, rcf_dn, rcf_up,
        rcf_loc, rcb_dn, rcb_up, rcb_loc, w_slot, r_slot, seq,
        kv_slot."""
        return np.stack([self.op, self.chunk, self.mb, self.src_slot,
                         self.act_slot, self.send,
                         self.recv_f["dn"], self.recv_f["up"],
                         self.recv_f["loc"],
                         self.recv_b["dn"], self.recv_b["up"],
                         self.recv_b["loc"],
                         self.w_slot,
                         self.r_slot, self.seq, self.kv_slot],
                        axis=-1).astype(np.int32)


def _op_code(kind: str, chunk: int, stage: int, P: int, v: int) -> int:
    if kind == F:
        if chunk == 0 and stage == 0:
            return FWD_FIRST
        if chunk == v - 1 and stage == P - 1:
            return FWD_LAST
        return FWD_MID
    first, last = chunk == 0 and stage == 0, chunk == v - 1 and stage == P - 1
    if kind == W:
        return WGT_FIRST if first else (WGT_LAST if last else WGT_MID)
    if kind == R:
        return RCP_FIRST if first else (RCP_LAST if last else RCP_MID)
    if first:
        return BWD_FIRST
    if last:
        return BWD_LAST
    return BWD_MID


def _payload_consumer(kind: str, chunk: int, stage: int, P: int, v: int):
    """(stage, chunk) of the task consuming this task's payload, or
    None (W/R tasks and the pipeline endpoints send nothing)."""
    if kind == F:
        if stage < P - 1:
            return stage + 1, chunk
        return (0, chunk + 1) if chunk < v - 1 else None
    if kind in (W, R):
        return None
    if stage > 0:
        return stage - 1, chunk
    return (P - 1, chunk - 1) if chunk > 0 else None


def _send_code(kind: str, chunk: int, stage: int, P: int, v: int,
               pl: Placement) -> int:
    cons = _payload_consumer(kind, chunk, stage, P, v)
    if cons is None:
        return SEND_NONE
    d0 = pl.device(stage, chunk)
    d1 = pl.device(cons[0], cons[1])
    hop = cons[1] != chunk          # chunk hop vs chain edge
    if kind == F:
        if d1 == d0:
            return SEND_F_LOC
        if hop:
            # a device-crossing chunk hop always uses the wrap channel
            # (edge-type, not delta: at P=2 the interleaved P-1 -> 0
            # hop *looks* like an up-shift but must stay on the wrap
            # route the legacy tables and the seqpipe runtime expect)
            assert (d0, d1) == (P - 1, 0), f"unroutable F hop {d0}->{d1}"
            return SEND_HOPF
        if d1 == d0 + 1:
            return SEND_FWD
        assert d1 == d0 - 1, f"unroutable F chain {d0}->{d1}"
        return SEND_F_UP
    if d1 == d0:
        return SEND_B_LOC
    if hop:
        assert (d0, d1) == (0, P - 1), f"unroutable B hop {d0}->{d1}"
        return SEND_HOPB
    if d1 == d0 - 1:
        return SEND_BWD
    assert d1 == d0 + 1, f"unroutable B chain {d0}->{d1}"
    return SEND_B_DOWN


# arrival channel of each send code (see module docstring: wraps land on
# the otherwise-unreceivable dn/up columns of the edge devices)
_SEND_CHANNEL = {SEND_FWD: "dn", SEND_HOPF: "dn", SEND_F_UP: "up",
                 SEND_F_LOC: "loc", SEND_BWD: "up", SEND_HOPB: "up",
                 SEND_B_DOWN: "dn", SEND_B_LOC: "loc"}


def build_task_table(sched: Schedule, overlap: bool = False) -> TaskTable:
    P, v, m, ns = sched.P, sched.v, sched.m, sched.n_seq
    pl = sched.pl
    rcs = sched.r_chunks()
    units = [(i, q) for i in range(m) for q in range(ns)]

    def dev(stage: int, chunk: int) -> int:
        return pl.device(stage, chunk)

    # ---- tick assignment (topological levels, device order preserved) --
    # ``overlap=False``: every dependency's payload/result is visible one
    # tick after production (the exchange runs synchronously inside the
    # producing tick).  ``overlap=True``: the double-buffered wire
    # delivers a cross-device payload DURING the tick after production
    # (overlapping that tick's compute), so its consumer needs a 2-tick
    # gap; same-device handoffs (local channels, ring stashes, device
    # order) stay 1-tick.  Per-device task order is identical in both
    # modes (same task sort, monotone per-device ticks), so gradient
    # accumulation order — and hence bitwise equivalence — is unchanged.
    xgap = 2 if overlap else 1
    tasks = sorted(sched.tasks, key=lambda t: (t.start, t.kind == B,
                                               t.stage))
    tick: Dict[Tuple, int] = {}
    dev_last = [-1] * P
    for t in tasks:
        d = dev(t.stage, t.chunk)
        lo = dev_last[d] + 1
        for dep in _dep_keys(t, P, v, rcs, ns):
            gap = xgap if dev(dep[3], dep[2]) != d else 1
            lo = max(lo, tick[dep] + gap)
        tick[t.key()] = lo
        dev_last[d] = lo
    T = max(tick.values()) + 1

    def ring_depth(open_kind, close_kind, chunks=None):
        """chunk -> max slots live between open_kind and close_kind ticks
        (the worst in-flight count over all stages).  ``close_kind`` may
        be a per-chunk callable."""
        depth: Dict[int, int] = {}
        for c in (range(v) if chunks is None else chunks):
            ck = close_kind(c) if callable(close_kind) else close_kind
            worst = 1
            for s in range(P):
                events = []
                for i, q in units:
                    events.append((tick[(open_kind, i, c, s, q)], 1))
                    events.append((tick[(ck, i, c, s, q)], -1))
                events.sort()
                cur = peak = 0
                for _, d in events:
                    cur += d
                    peak = max(peak, cur)
                worst = max(worst, peak)
            depth[c] = worst
        return depth

    # Forward-only schedules (inference prefill, repro_torch.seqpipe
    # ``forward_only``): no backward readers exist, so the activation /
    # W-stash / remat rings degenerate — boundary payloads go straight
    # to the wire and act slots stay -1.  Only the KV-carry ring
    # survives (closing at the microbatch's last seq chunk instead of
    # its first backward).
    fwd_only = not any(t.kind == B for t in sched.tasks)

    # activation rings hold boundary payloads: lifetime F -> R for
    # rematerialized chunks (the remat tick takes over), F -> B otherwise.
    # W-stash rings (split backward: boundary payload + upstream grad
    # residuals) live B -> W; remat rings live R -> B.
    if fwd_only:
        act_depth = {c: 1 for c in range(v)}
        has_w = False
        wstash_depth: Dict[int, int] = {}
        rmt_depth: Dict[int, int] = {}
    else:
        act_depth = ring_depth(F, lambda c: R if c in rcs else B)
        has_w = sched.has_w
        wstash_depth = ring_depth(B, W) if has_w else {}
        rmt_depth = ring_depth(R, B, sorted(rcs)) if rcs else {}

    # ---- seq-chunked extras ----
    # KV-carry ring: one slot per in-flight *microbatch* (all its seq
    # chunks share the full-sequence K/V buffer), alive F[mb,0]->B[mb,0]
    # — FIFO by mb, so mb % depth is sound.  The activation ring is NOT
    # FIFO under seq chunking (backwards retire in reverse seq order
    # within a microbatch): replace the modular slot assignment with
    # exact per-stage interval coloring.
    kv_depth: Dict[int, int] = {}
    act_color: Dict[Tuple, int] = {}     # (c, s, mb, q) -> slot
    if ns > 1:
        for c in range(v):
            worst = 1
            for s in range(P):
                events = []
                for i in range(m):
                    events.append((tick[(F, i, c, s, 0)], 1))
                    # fwd-only: the table's KV lifetime ends at the last
                    # seq chunk (the serving engine then hands the slot
                    # to the decode phase outside the table)
                    close = tick[(F, i, c, s, ns - 1)] if fwd_only \
                        else tick[(B, i, c, s, 0)]
                    events.append((close, -1))
                events.sort()
                cur = peak = 0
                for _, d in events:
                    cur += d
                    peak = max(peak, cur)
                worst = max(worst, peak)
            kv_depth[c] = worst
    if ns > 1 and not fwd_only:
        act_depth = {}
        close_kind = {c: (R if c in rcs else B) for c in range(v)}
        for c in range(v):
            worst = 1
            for s in range(P):
                ivs = sorted(
                    (tick[(F, i, c, s, q)],
                     tick[(close_kind[c], i, c, s, q)], (i, q))
                    for i, q in units)
                active: List[Tuple[int, int]] = []   # (free_tick, slot)
                free_slots: List[int] = []
                nslots = 0
                for a, b_, unit in ivs:
                    still = []
                    for fb, sl in active:
                        # reader tick b_ still *uses* the slot: free
                        # strictly after it
                        if fb < a:
                            free_slots.append(sl)
                        else:
                            still.append((fb, sl))
                    active = still
                    sl = free_slots.pop() if free_slots else nslots
                    if sl == nslots:
                        nslots += 1
                    active.append((b_, sl))
                    act_color[(c, s) + unit] = sl
                worst = max(worst, nslots)
            act_depth[c] = worst

    # ---- payload edges & queue coloring ----
    # F payload: F(i,c,s,q) -> F(i,c,s+1,q) | F(i,c,P-1,q) -> F(i,c+1,0,q)
    # B payload: B(i,c,s,q) -> B(i,c,s-1,q) | B(i,c,0,q) -> B(i,c-1,P-1,q)
    f_edges, b_edges = [], []
    for i, q in units:
        for c in range(v):
            for s in range(P):
                if s < P - 1:
                    f_edges.append(((F, i, c, s, q), (F, i, c, s + 1, q)))
                elif c < v - 1:
                    f_edges.append(((F, i, c, s, q), (F, i, c + 1, 0, q)))
                if fwd_only:
                    continue
                if s > 0:
                    b_edges.append(((B, i, c, s, q), (B, i, c, s - 1, q)))
                elif c > 0:
                    b_edges.append(((B, i, c, s, q),
                                    (B, i, c - 1, P - 1, q)))

    def color(edges):
        """Greedy interval coloring per consumer *device* (the queue
        buffers live per device).  Interval: (arrive=tick[prod],
        free=tick[cons]]."""
        slots: Dict[Tuple, int] = {}
        depth = 1
        per_stage: Dict[int, List[Tuple[int, int, Tuple]]] = {}
        for prod, cons in edges:
            per_stage.setdefault(dev(cons[3], cons[2]), []).append(
                (tick[prod], tick[cons], prod))
        for s, ivs in per_stage.items():
            ivs.sort()
            active: List[Tuple[int, int]] = []   # (free_tick, slot)
            free_slots: List[int] = []
            nslots = 0
            for a, b_, prod in ivs:
                # release expired
                still = []
                for fb, sl in active:
                    if fb <= a:
                        free_slots.append(sl)
                    else:
                        still.append((fb, sl))
                active = still
                if free_slots:
                    sl = free_slots.pop()
                else:
                    sl = nslots
                    nslots += 1
                active.append((b_, sl))
                slots[prod] = sl
                depth = max(depth, nslots)
        return slots, depth

    f_slots, fq_depth = color(f_edges)
    b_slots, bq_depth = color(b_edges)
    cons_f = {prod: cons for prod, cons in f_edges}
    cons_b = {prod: cons for prod, cons in b_edges}

    # ---- emit table ----
    shape = (T, P)
    op = np.zeros(shape, np.int32)
    chunk = np.zeros(shape, np.int32)
    mbt = np.zeros(shape, np.int32)
    src = -np.ones(shape, np.int32)
    act = -np.ones(shape, np.int32)
    snd = np.zeros(shape, np.int32)
    rcf = {ch: -np.ones(shape, np.int32) for ch in RECV_CHANNELS}
    rcb = {ch: -np.ones(shape, np.int32) for ch in RECV_CHANNELS}
    wsl = -np.ones(shape, np.int32)
    rsl = -np.ones(shape, np.int32)
    seq = np.zeros(shape, np.int32)
    kvs = -np.ones(shape, np.int32)

    for t in sched.tasks:
        tt, s, q = tick[t.key()], t.stage, t.seq
        d = dev(s, t.chunk)              # the table column (device)
        # backward-phase unit order (writers and readers of the W-stash
        # and remat rings both follow it, so mod-depth stays FIFO)
        beta = t.mb * ns + (ns - 1 - q)
        oc = _op_code(t.kind, t.chunk, s, P, v)
        op[tt, d] = oc
        chunk[tt, d] = t.chunk
        mbt[tt, d] = t.mb
        seq[tt, d] = q
        code = _send_code(t.kind, t.chunk, s, P, v, pl)
        snd[tt, d] = code
        # KV-carry/dKV ring slot (FIFO by mb): every F appends its
        # chunk's K/V; every B replays from it and accumulates dKV
        if ns > 1 and t.kind in (F, B):
            kvs[tt, d] = t.mb % kv_depth[t.chunk]
        # W-stash slot: written at the B tick, read at W
        if has_w and t.kind in (B, W):
            wsl[tt, d] = beta % wstash_depth[t.chunk]
        # remat-ring slot: written at R, read at the B.
        # First-position blocks have no boundary payload to hand off
        # (their input is the token batch, re-fetched at B time).
        if t.chunk in rcs and t.kind in (R, B) \
                and oc not in (RCP_FIRST, BWD_FIRST):
            rsl[tt, d] = beta % rmt_depth[t.chunk]
        # boundary activation slot (FIFO by mb when n_seq == 1, exact
        # interval coloring otherwise); rematerialized chunks retire
        # their act slot at the R tick, so their B reads the remat ring
        if t.kind != W and oc not in (FWD_FIRST, BWD_FIRST, RCP_FIRST) \
                and not (t.kind == B and t.chunk in rcs) and not fwd_only:
            act[tt, d] = (t.mb % act_depth[t.chunk] if ns == 1
                          else act_color[(t.chunk, s, t.mb, q)])
        # input queue slot
        if t.kind == F and oc not in (FWD_FIRST,):
            prod = (F, t.mb, t.chunk, s - 1, q) if s > 0 else \
                (F, t.mb, t.chunk - 1, P - 1, q)
            src[tt, d] = f_slots[prod]
        if t.kind == B and oc not in (BWD_LAST,):
            prod = (B, t.mb, t.chunk, s + 1, q) if s < P - 1 else \
                (B, t.mb, t.chunk + 1, 0, q)
            src[tt, d] = b_slots[prod]
        # receive side: the payload I produce lands at the consumer's
        # device this tick, on the channel my send code feeds
        if t.kind == F and t.key() in cons_f:
            ck = cons_f[t.key()]
            cd, ch = dev(ck[3], ck[2]), _SEND_CHANNEL[code]
            assert rcf[ch][tt, cd] < 0, \
                f"tick {tt}: two F payloads on channel {ch} at device {cd}"
            rcf[ch][tt, cd] = f_slots[t.key()]
        if t.kind == B and t.key() in cons_b:
            ck = cons_b[t.key()]
            cd, ch = dev(ck[3], ck[2]), _SEND_CHANNEL[code]
            assert rcb[ch][tt, cd] < 0, \
                f"tick {tt}: two B payloads on channel {ch} at device {cd}"
            rcb[ch][tt, cd] = b_slots[t.key()]

    return TaskTable(P=P, v=v, m=m, T=T, op=op, chunk=chunk, mb=mbt,
                     src_slot=src, act_slot=act, send=snd, recv_f=rcf,
                     recv_b=rcb, w_slot=wsl, r_slot=rsl, seq=seq,
                     kv_slot=kvs, fq_depth=fq_depth,
                     bq_depth=bq_depth, act_depth=act_depth,
                     wstash_depth=wstash_depth, rmt_depth=rmt_depth,
                     name=sched.name, n_seq=ns, kv_depth=kv_depth,
                     placement_name=pl.name,
                     overlap=overlap)


F_OPS = (FWD_MID, FWD_FIRST, FWD_LAST)
B_OPS = (BWD_MID, BWD_FIRST, BWD_LAST)
W_OPS = (WGT_MID, WGT_FIRST, WGT_LAST)
R_OPS = (RCP_MID, RCP_FIRST, RCP_LAST)

# columns of TaskTable.arrays()
COL_ACT, COL_W, COL_R, COL_KV = 4, 12, 13, 15


def derive_slots(tab: TaskTable) -> Dict[int, np.ndarray]:
    """The FIFO ring-slot columns of :meth:`TaskTable.arrays`,
    recomputed from each row's ``(op, chunk, mb, seq)`` by the formulas
    of :func:`build_task_table` (``beta % depth`` in the backward unit
    order, the op codes deciding which rows carry a slot): the W-stash,
    remat and KV-carry columns, and the activation column where it is
    FIFO (``n_seq == 1``; sequence chunking colors it by interval).
    :func:`validate_table` holds the table to them."""
    op, chunk, mb, seq = tab.op, tab.chunk, tab.mb, tab.seq
    v, ns = tab.v, tab.n_seq
    rcs = np.asarray([int(c in tab.rmt_depth) for c in range(v)])

    def depth_arr(d: Dict[int, int]):
        return np.asarray([max(int(d.get(c, 0)), 1) for c in range(v)])

    beta = mb * ns + (ns - 1 - seq)
    is_f, is_b = np.isin(op, F_OPS), np.isin(op, B_OPS)
    is_w, is_r = np.isin(op, W_OPS), np.isin(op, R_OPS)
    is_rc = rcs[chunk] > 0
    out = {}
    out[COL_W] = np.where((is_b | is_w) & tab.has_w,
                          beta % depth_arr(tab.wstash_depth)[chunk], -1)
    out[COL_R] = np.where(
        is_rc & (is_r | is_b) & (op != RCP_FIRST) & (op != BWD_FIRST),
        beta % depth_arr(tab.rmt_depth)[chunk], -1)
    if ns > 1:
        out[COL_KV] = np.where(is_f | is_b,
                               mb % depth_arr(tab.kv_depth)[chunk], -1)
    else:
        out[COL_KV] = -np.ones_like(op)
        has_act = (is_f | is_b | is_r) & (op != FWD_FIRST) \
            & (op != BWD_FIRST) & (op != RCP_FIRST) & ~(is_b & is_rc) \
            & (not tab.fwd_only)        # prefill tables carry no act ring
        out[COL_ACT] = np.where(has_act,
                                mb % depth_arr(tab.act_depth)[chunk], -1)
    return out


def validate_table(tab: TaskTable) -> None:
    """Re-derive invariants: every task present once; reads see writes;
    every stash ring (W-stash, remat, the act ring of rematerialized or
    sequence-chunked tables, and the KV-carry ring) is safe — a slot is
    never overwritten before its matching reader retires it."""
    P, v, m, ns = tab.P, tab.v, tab.m, tab.n_seq
    seen = set()
    for t in range(tab.T):
        for s in range(P):
            o = tab.op[t, s]
            if o == IDLE:
                continue
            if o in (FWD_MID, FWD_FIRST, FWD_LAST):
                kind = F
            elif o in (WGT_MID, WGT_FIRST, WGT_LAST):
                kind = W
            elif o in (RCP_MID, RCP_FIRST, RCP_LAST):
                kind = R
            else:
                kind = B
            key = (kind, int(tab.mb[t, s]), int(tab.chunk[t, s]), s,
                   int(tab.seq[t, s]))
            assert key not in seen, f"duplicate {key}"
            seen.add(key)
    kinds = 1 if tab.fwd_only else (3 if tab.has_w else 2)
    assert len(seen) == (kinds * P * v * m
                         + len(tab.rmt_depth) * P * m) * ns

    def unit(t, s):
        return int(tab.mb[t, s]), int(tab.seq[t, s])

    # W-stash ring: the slot written at a B tick must stay live (not be
    # overwritten by a later B) until its matching W tick reads it.
    # beta % depth is only sound for FIFO retirement — enforce it here
    # rather than assume it of future split-backward generators.
    if tab.has_w:
        for s in range(P):
            live: Dict[Tuple[int, int], Tuple] = {}  # (chunk, slot) -> unit
            for t in range(tab.T):
                o = tab.op[t, s]
                if o in (BWD_MID, BWD_FIRST, BWD_LAST):
                    key = (int(tab.chunk[t, s]), int(tab.w_slot[t, s]))
                    assert key not in live, \
                        f"stage {s} tick {t}: W-stash {key} overwritten " \
                        f"before W of {live[key]} read it"
                    live[key] = unit(t, s)
                elif o in (WGT_MID, WGT_FIRST, WGT_LAST):
                    key = (int(tab.chunk[t, s]), int(tab.w_slot[t, s]))
                    assert live.get(key) == unit(t, s), \
                        f"stage {s} tick {t}: W reads stash {key} not " \
                        f"holding its unit"
                    del live[key]
            assert not live, f"stage {s}: unread W-stash slots {live}"
    # remat ring: written at the R tick, read (and retired) at the
    # chunk's B tick; and the act ring of rematerialized chunks:
    # written at F, retired at R.  Slot reuse is only sound when no
    # writer lands on a live slot — enforce both here.
    if tab.has_r:
        rcs = set(tab.rmt_depth)
        for (wr_ops, rd_ops, slots, label) in (
                ((RCP_MID, RCP_FIRST, RCP_LAST),
                 (BWD_MID, BWD_FIRST, BWD_LAST), tab.r_slot, "remat"),
                ((FWD_MID, FWD_FIRST, FWD_LAST),
                 (RCP_MID, RCP_FIRST, RCP_LAST), tab.act_slot, "act(F->R)")):
            for s in range(P):
                live: Dict[Tuple[int, int], Tuple] = {}
                for t in range(tab.T):
                    o = tab.op[t, s]
                    c = int(tab.chunk[t, s])
                    if c not in rcs or int(slots[t, s]) < 0:
                        continue
                    key = (c, int(slots[t, s]))
                    if o in wr_ops:
                        assert key not in live, \
                            f"stage {s} tick {t}: {label} ring {key} " \
                            f"overwritten before {live[key]} read it"
                        live[key] = unit(t, s)
                    elif o in rd_ops:
                        assert live.get(key) == unit(t, s), \
                            f"stage {s} tick {t}: {label} ring read " \
                            f"{key} not holding its unit"
                        del live[key]
                assert not live, \
                    f"stage {s}: unread {label} ring slots {live}"
    # sequence-chunked tables: the colored act ring (write at F, single
    # terminal read at B — or R for rematerialized chunks) and the
    # KV-carry ring (claimed at F[mb,0], every later F/B of the mb must
    # see its own slot, released at B[mb,0]).
    if ns > 1:
        rcs = set(tab.rmt_depth)
        fwd_o = tab.fwd_only
        for s in range(P):
            live_act: Dict[Tuple[int, int], Tuple] = {}
            live_kv: Dict[Tuple[int, int], int] = {}   # (c, slot) -> mb
            for t in range(tab.T):
                o = tab.op[t, s]
                if o == IDLE:
                    continue
                c = int(tab.chunk[t, s])
                mb, q = unit(t, s)
                a_sl = int(tab.act_slot[t, s])
                kv_sl = int(tab.kv_slot[t, s])
                is_f = o in (FWD_MID, FWD_FIRST, FWD_LAST)
                is_b = o in (BWD_MID, BWD_FIRST, BWD_LAST)
                is_r = o in (RCP_MID, RCP_FIRST, RCP_LAST)
                if is_f and a_sl >= 0:
                    key = (c, a_sl)
                    assert key not in live_act, \
                        f"stage {s} tick {t}: act slot {key} " \
                        f"overwritten before {live_act[key]} read it"
                    live_act[key] = (mb, q)
                elif a_sl >= 0 and (is_r or (is_b and c not in rcs)):
                    key = (c, a_sl)
                    assert live_act.get(key) == (mb, q), \
                        f"stage {s} tick {t}: act read {key} not " \
                        f"holding its unit"
                    del live_act[key]
                if kv_sl >= 0 and (is_f or is_b):
                    key = (c, kv_sl)
                    if is_f and q == 0:
                        assert key not in live_kv, \
                            f"stage {s} tick {t}: KV slot {key} " \
                            f"reclaimed while mb {live_kv.get(key)} live"
                        live_kv[key] = mb
                        # fwd-only, ns-boundary: release below
                    else:
                        assert live_kv.get(key) == mb, \
                            f"stage {s} tick {t}: KV slot {key} does " \
                            f"not hold mb {mb}"
                    # fwd-only tables release at the last seq chunk
                    # (serving hands the slot to decode outside the
                    # table); training tables release at B[mb, 0]
                    if (is_b and q == 0) or \
                            (fwd_o and is_f and q == ns - 1):
                        if key in live_kv:
                            del live_kv[key]
            assert not live_act, f"stage {s}: unread act slots {live_act}"
            assert not live_kv, f"stage {s}: unreleased KV slots {live_kv}"
    # the FIFO ring columns follow their formulas
    arr = tab.arrays()
    for col, want in derive_slots(tab).items():
        assert (arr[..., col] == want).all(), \
            f"ring column {col} is not its FIFO formula"
    # queue writes land in range and at most one payload per (tick,
    # device, channel); a device receives at most one F and one B
    # payload per (tick, channel) by construction
    for qname, rc, depth in (("F", tab.recv_f, tab.fq_depth),
                             ("B", tab.recv_b, tab.bq_depth)):
        for ch, arr in rc.items():
            assert arr.shape == tab.op.shape
            assert int(arr.max(initial=-1)) < depth, \
                f"{qname}-queue {ch} slot out of range"
    # (full read/write causality is covered by the numerical equivalence
    #  test of the executor against single-device autodiff)
