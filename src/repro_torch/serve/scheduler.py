"""Continuous-batching admission layer (Orca-style iteration-level
scheduling) for the pipelined serving engine — the port's own copy of
``repro.serve.scheduler`` (pure Python, framework-free).

The scheduler maps requests onto the engine's **slots** and decides,
tick by tick, what enters the pipeline at stage 0.  The engine drives
it through a two-call protocol:

- :meth:`SlotScheduler.next_injection` — called once per pipeline tick;
  returns the :class:`Injection` to feed stage 0 (possibly ``IDLE``).
- :meth:`SlotScheduler.on_result` — called when that injection's wave
  exits the last stage ``P - 1`` ticks later with the sampled token.

Scheduling rules (all deterministic, identical to the reference):

- **admission**: FIFO queue -> lowest free slot, as soon as one drains.
- **prefill** streams a prompt through the stages in sequence chunks of
  ``chunk`` tokens, back-to-back — one chunk per tick, microbatch-major
  (the stage-0 order of the forward-only ``seq1f1b`` task table).  Only
  the last chunk samples.
- **decode** rides steady-state ticks: slot ``k``'s next token can be
  injected the tick after its previous sample returns, i.e. one token
  per pipeline revolution (``P`` ticks).  Ready decodes win over
  prefill chunks (latency first), oldest-ready first.
- **preemption** (longest-first eviction): when the queue head has
  waited more than ``preempt_after`` ticks with no free slot, the
  active request with the most generated tokens (not mid-sample) is
  evicted and requeued at the back; each request is preempted at most
  once and restarts from scratch — greedy decoding regenerates the
  identical token stream.

**Request lifecycle.**  Every submitted request reaches *exactly one*
terminal state, recorded in :attr:`SlotScheduler.outcomes`:
``completed`` (all ``max_new`` tokens delivered), ``expired`` (its
deadline passed, queued or active), ``shed`` (rejected at admission
with the queue at ``max_queue``) or ``failed`` (a slot corruption
evicted it more than ``max_retries`` times).

Fault re-admission (:meth:`SlotScheduler.fail_slot` for an injected
corruption, :meth:`SlotScheduler.fail_all` for a device loss) frees the
victim's slot and requeues the request *at the front* for
**re-prefill**: its cache is gone, so the prompt streams through the
prefill path again and greedy decoding regenerates the identical stream.
Corruption evictions are bounded by ``max_retries``; device-loss
re-admissions are the system's fault and never consume retry budget.  A
per-admission ``gen`` counter travels with every injection so waves
sampled before an eviction are recognised as stale and discarded.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

IDLE, PREFILL, DECODE = 0, 1, 2

# terminal request states (exactly one per submitted request)
COMPLETED, EXPIRED, SHED, FAILED = \
    "completed", "expired", "shed", "failed"
TERMINAL_STATES = (COMPLETED, EXPIRED, SHED, FAILED)


@dataclasses.dataclass
class Request:
    """One serving request: ``prompt`` token ids, generate ``max_new``
    tokens greedily.  ``arrival_s`` orders Poisson traffic replay.
    ``deadline`` is an optional completion budget measured from
    submission, in whatever time base the driver passes as ``now``
    (wall seconds for ``clock="wall"`` serving, scheduler ticks when no
    ``now`` is given); past it the request is cancelled on time and
    terminally ``expired``."""
    rid: int
    prompt: List[int]
    max_new: int
    arrival_s: float = 0.0
    deadline: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Injection:
    """What stage 0 consumes this tick (one row of the engine's ctl).

    ``op``: IDLE/PREFILL/DECODE; ``slot``: request slot; ``pos``: write
    offset into the slot's KV/SSM cache; ``first``: 1 on a request's
    first prefill chunk (the engine zeroes the slot's carried state —
    stale SSM/conv state from the slot's previous tenant must not leak,
    and attention K/V is zeroed along with it so the slot equals a
    fresh single-host cache bitwise); ``tokens``: the chunk (prefill)
    or the previous sampled token (decode); ``sample``: the head output
    of this wave is consumed (last prefill chunk + every decode);
    ``gen``: the admission generation of ``rid`` — a wave from before a
    fault eviction carries a stale ``gen`` and its result is dropped."""
    op: int
    slot: int = 0
    pos: int = 0
    first: int = 0
    tokens: Tuple[int, ...] = ()
    sample: bool = False
    rid: int = -1
    gen: int = 0


IDLE_INJ = Injection(op=IDLE)


@dataclasses.dataclass
class _Active:
    req: Request
    slot: int
    admit_tick: int
    chunks: deque          # remaining prefill chunks: (pos, tokens)
    generated: List[int] = dataclasses.field(default_factory=list)
    inflight: bool = False          # a sampling wave is in the pipe
    next_token: Optional[int] = None
    gen: int = 0                    # admission generation (stale guard)


@dataclasses.dataclass
class FinishedRecord:
    rid: int
    tokens: List[int]
    prompt_len: int
    submit_tick: int
    admit_tick: int
    first_token_tick: int
    done_tick: int
    preemptions: int
    retries: int = 0


@dataclasses.dataclass
class DroppedRecord:
    """Terminal record of a request that did not complete."""
    rid: int
    state: str                      # expired | shed | failed
    tick: int                       # when the terminal state was reached
    prompt_len: int
    n_generated: int                # tokens delivered before the drop
    retries: int = 0


class SlotScheduler:
    """Maps requests onto ``n_slots`` pipeline slots; see module doc."""

    def __init__(self, n_slots: int, chunk: int, max_seq: int,
                 preempt_after: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 max_retries: int = 3):
        assert n_slots >= 1 and chunk >= 1
        assert max_queue is None or max_queue >= 0
        assert max_retries >= 0
        self.n_slots, self.chunk, self.max_seq = n_slots, chunk, max_seq
        self.preempt_after = preempt_after
        self.max_queue = max_queue
        self.max_retries = max_retries
        self.queue: deque = deque()          # pending Requests
        self.active: Dict[int, _Active] = {}     # slot -> state
        self.ready: deque = deque()          # slots with a token to feed
        self.finished: Dict[int, FinishedRecord] = {}
        self.outcomes: Dict[int, str] = {}   # rid -> terminal state
        self.dropped: Dict[int, DroppedRecord] = {}
        self.preemptions: Dict[int, int] = {}    # rid -> times evicted
        self.retries: Dict[int, int] = {}    # rid -> fault re-admissions
        self.n_with_deadline = 0
        self._first_tick: Dict[int, int] = {}    # rid -> first-token tick
        self._submit_tick: Dict[int, int] = {}
        self._deadline_at: Dict[int, float] = {}     # rid -> absolute
        self._gen: Dict[int, int] = {}       # rid -> admission generation
        self.tick = 0

    # -- intake -----------------------------------------------------------
    def submit(self, req: Request, now: Optional[float] = None) -> bool:
        """Enqueue ``req``; returns False when it was load-shed (queue
        at ``max_queue``), in which case its terminal state is ``shed``
        and it never occupies queue or slot state.  ``now`` anchors the
        deadline (defaults to the current tick)."""
        assert len(req.prompt) + req.max_new <= self.max_seq, \
            f"request {req.rid} exceeds max_seq {self.max_seq}"
        assert len(req.prompt) >= 1 and req.max_new >= 1
        assert len(req.prompt) % self.chunk == 0, \
            f"prompt len {len(req.prompt)} not a multiple of the " \
            f"prefill chunk {self.chunk} (pad upstream)"
        self._submit_tick.setdefault(req.rid, self.tick)
        if req.deadline is not None:
            self.n_with_deadline += 1
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._drop(req.rid, SHED, prompt_len=len(req.prompt),
                       n_generated=0)
            return False
        if req.deadline is not None:
            base = float(self.tick) if now is None else now
            self._deadline_at[req.rid] = base + req.deadline
        self.queue.append(req)
        return True

    @property
    def idle(self) -> bool:
        """No admitted, queued, or in-flight work left."""
        return not self.queue and not self.active

    # -- per-tick protocol ------------------------------------------------
    def next_injection(self, now: Optional[float] = None) -> Injection:
        self.tick += 1
        self._expire(float(self.tick) if now is None else now)
        self._maybe_preempt()
        self._admit()
        # ready decodes first (oldest first): one token per revolution
        if self.ready:
            slot = self.ready.popleft()
            a = self.active[slot]
            tok = a.next_token
            a.next_token = None
            a.inflight = True
            # the fed token is generated[-1], written at this position
            pos = len(a.req.prompt) + len(a.generated) - 1
            return Injection(op=DECODE, slot=slot, pos=pos,
                             tokens=(tok,), sample=True, rid=a.req.rid,
                             gen=a.gen)
        # else advance a prefilling request in admission order; all of
        # one request's chunks go back-to-back — the microbatch-major
        # stage-0 order of the forward-only seq1f1b table
        for a in sorted(self.active.values(),
                        key=lambda a: (a.admit_tick, a.slot)):
            if not a.chunks:
                continue
            pos, toks = a.chunks.popleft()
            last = not a.chunks
            if last:
                a.inflight = True
            return Injection(op=PREFILL, slot=a.slot, pos=pos,
                             first=int(pos == 0), tokens=toks,
                             sample=last, rid=a.req.rid, gen=a.gen)
        return IDLE_INJ

    def on_result(self, inj: Injection, token: int) -> bool:
        """Deliver the sampled token of ``inj``'s wave (the engine calls
        this ``P - 1`` ticks after injection, when the wave has exited
        the last stage).  Returns True when the token was accepted —
        False for idle/stale waves (slot preempted, retired, expired,
        or re-admitted under a newer ``gen``), whose result the engine
        must not count as a delivered token."""
        if inj.op == IDLE or not inj.sample:
            return False
        a = self.active.get(inj.slot)
        if a is None or a.req.rid != inj.rid or a.gen != inj.gen:
            return False          # the wave predates the current tenant
        a.inflight = False
        a.generated.append(int(token))
        rid = a.req.rid
        if rid not in self._first_tick:
            self._first_tick[rid] = self.tick
        if len(a.generated) >= a.req.max_new:
            self._finish(inj.slot, a)
        else:
            a.next_token = int(token)
            self.ready.append(inj.slot)
        return True

    # -- fault re-admission ----------------------------------------------
    def fail_slot(self, slot: int, reason: str = "slot_corruption",
                  count_retry: bool = True) -> Optional[int]:
        """Evict ``slot``'s request (its cache is corrupted or gone) and
        re-admit it via re-prefill at the front of the queue; its
        generated tokens are discarded.  Past ``max_retries`` counted
        evictions the request is terminally ``failed``.  Returns the
        victim rid (None if the slot was empty)."""
        a = self.active.get(slot)
        if a is None:
            return None
        self._evict(slot)
        rid = a.req.rid
        self.retries[rid] = self.retries.get(rid, 0) + 1
        if count_retry and self.retries[rid] > self.max_retries:
            self._drop(rid, FAILED, prompt_len=len(a.req.prompt),
                       n_generated=len(a.generated))
        else:
            self.queue.appendleft(a.req)
        return rid

    def fail_all(self, reason: str = "device_loss") -> List[int]:
        """Device-loss re-admission: every active request lost its slot
        cache with the failed stage.  Evicts all of them (stale waves die
        with the old engine) and requeues them at the front in admission
        order for re-prefill, without consuming retry budget.  Returns
        the victim rids oldest-first."""
        victims = sorted(self.active.values(),
                         key=lambda a: (a.admit_tick, a.slot))
        rids = []
        for a in victims:
            self._evict(a.slot)
            rid = a.req.rid
            self.retries[rid] = self.retries.get(rid, 0) + 1
            rids.append(rid)
        for a in reversed(victims):
            self.queue.appendleft(a.req)
        return rids

    # -- lifecycle summary -------------------------------------------------
    def lifecycle_counts(self) -> Dict[str, Optional[int]]:
        """Terminal-state tally + fault/deadline counters (the fields
        :func:`repro_torch.serve.traffic.summarize` publishes)."""
        tally = {s: 0 for s in TERMINAL_STATES}
        for s in self.outcomes.values():
            tally[s] += 1
        hits = sum(1 for rid in self.finished
                   if rid in self._deadline_at)
        return {
            "completed": tally[COMPLETED], "expired": tally[EXPIRED],
            "shed": tally[SHED], "failed": tally[FAILED],
            "retries": sum(self.retries.values()),
            "preemptions": sum(self.preemptions.values()),
            "with_deadline": self.n_with_deadline,
            "deadline_hits": hits if self.n_with_deadline else None,
        }

    # -- internals --------------------------------------------------------
    def _chunks_of(self, req: Request) -> deque:
        c = self.chunk
        return deque((q * c, tuple(req.prompt[q * c:(q + 1) * c]))
                     for q in range(len(req.prompt) // c))

    def _admit(self) -> None:
        while self.queue and len(self.active) < self.n_slots:
            req = self.queue.popleft()
            slot = min(set(range(self.n_slots)) - set(self.active))
            assert slot not in self.active, "slot double-allocation"
            gen = self._gen[req.rid] = self._gen.get(req.rid, -1) + 1
            self.active[slot] = _Active(req=req, slot=slot,
                                        admit_tick=self.tick,
                                        chunks=self._chunks_of(req),
                                        gen=gen)

    def _expire(self, now: float) -> None:
        """On-time cancellation: drop every queued or active request
        whose deadline passed.  Active victims free their slot the same
        tick; a mid-flight sampling wave is recognised as stale by its
        ``gen`` and discarded on arrival."""
        if not self._deadline_at:
            return
        if self.queue and any(self._deadline_at.get(r.rid, now) < now
                              for r in self.queue):
            kept = deque()
            for req in self.queue:
                if self._deadline_at.get(req.rid, now) < now:
                    self._drop(req.rid, EXPIRED,
                               prompt_len=len(req.prompt), n_generated=0)
                else:
                    kept.append(req)
            self.queue = kept
        for slot, a in sorted(self.active.items()):
            if self._deadline_at.get(a.req.rid, now) < now:
                self._evict(slot)
                self._drop(a.req.rid, EXPIRED,
                           prompt_len=len(a.req.prompt),
                           n_generated=len(a.generated))

    def _evict(self, slot: int) -> None:
        """Free ``slot`` (no terminal state; callers decide requeue vs
        drop).  Bumps the stored generation so any wave of the evicted
        tenant still in the pipe is stale on arrival."""
        a = self.active.pop(slot)
        if slot in self.ready:
            self.ready.remove(slot)
        self._first_tick.pop(a.req.rid, None)
        self._gen[a.req.rid] = a.gen + 1

    def _drop(self, rid: int, state: str, *, prompt_len: int,
              n_generated: int) -> None:
        assert state in (EXPIRED, SHED, FAILED)
        assert rid not in self.outcomes, \
            f"request {rid} reached a second terminal state {state}"
        self.outcomes[rid] = state
        self.dropped[rid] = DroppedRecord(
            rid=rid, state=state, tick=self.tick, prompt_len=prompt_len,
            n_generated=n_generated, retries=self.retries.get(rid, 0))

    def _maybe_preempt(self) -> None:
        if (self.preempt_after is None or not self.queue
                or len(self.active) < self.n_slots):
            return
        head = self.queue[0]
        waited = self.tick - self._submit_tick[head.rid]
        if waited <= self.preempt_after:
            return
        # longest-first: evict the (not mid-sample, not already
        # preempted) request with the most generated tokens
        victims = [a for a in self.active.values()
                   if not a.inflight
                   and self.preemptions.get(a.req.rid, 0) == 0]
        if not victims:
            return
        v = max(victims, key=lambda a: (len(a.generated), -a.slot))
        self.preemptions[v.req.rid] = \
            self.preemptions.get(v.req.rid, 0) + 1
        self._evict(v.slot)
        self.queue.append(v.req)           # restart from scratch later

    def _finish(self, slot: int, a: _Active) -> None:
        rid = a.req.rid
        assert rid not in self.outcomes, \
            f"request {rid} reached a second terminal state completed"
        self.outcomes[rid] = COMPLETED
        self.finished[rid] = FinishedRecord(
            rid=rid, tokens=list(a.generated),
            prompt_len=len(a.req.prompt),
            submit_tick=self._submit_tick[rid],
            admit_tick=a.admit_tick,
            first_token_tick=self._first_tick[rid],
            done_tick=self.tick,
            preemptions=self.preemptions.get(rid, 0),
            retries=self.retries.get(rid, 0))
        del self.active[slot]              # slot drains -> next admit


def prefill_injection_order(P: int, m: int, n_seq: int,
                            schedule: str = "seq1f1b") -> List[Tuple[int,
                                                                     int]]:
    """Stage-0 (mb, seq-chunk) injection order of the forward-only task
    table: what the pipeline executes when ``m`` prompts of ``n_seq``
    chunks stream through ``P`` stages.  The admission layer's
    back-to-back chunk policy replays exactly this order
    (microbatch-major)."""
    from repro_torch.core.tasktable import IDLE as OP_IDLE
    from repro_torch.core.tasktable import build_task_table
    from repro_torch.seqpipe.schedules import forward_only, seq1f1b
    assert schedule == "seq1f1b", "only seq1f1b prefill tables for now"
    tab = build_task_table(forward_only(seq1f1b(P, m, n_seq)))
    return [(int(tab.mb[t, 0]), int(tab.seq[t, 0]))
            for t in range(tab.T) if tab.op[t, 0] != OP_IDLE]
