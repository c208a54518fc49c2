"""Deterministic fault injection for the training drivers (own copy of
``repro/ft/inject.py``; the crash seams patched are the port's
:mod:`repro_torch.ft.checkpoint`).

Real clusters fail asynchronously; tests cannot.  This module turns the
four failure modes the elastic story must survive into *step-keyed,
replayable* triggers that fire at exact points inside
``train_pipeline``'s loop and at the ``Watchdog`` / ``HealthMonitor``
seams — so a recovery test is a pure function of its fault list:

- :class:`DeviceLoss` — a pipeline stage dies.  Raised from
  ``on_step_start`` as :class:`DeviceLossError` *before* the step runs
  (the surviving collective participants would see a NCCL abort there).
- :class:`HungCollective` — a peer stops responding mid-step.  The
  injector advances its fake monotonic clock past the armed
  ``Watchdog``'s timeout in ``on_step_end``; the watchdog check then
  converts the hang into a :class:`DeviceLossError`.
- :class:`CheckpointCrash` — the checkpoint writer dies either
  mid-``write`` (at a byte offset inside a leaf file) or *between* the
  tmp-dir write and the atomic ``os.rename``.  Installed as one-shot
  patches over :mod:`repro_torch.ft.checkpoint`'s module seams
  (``_write_file`` / ``_rename``); the previous checkpoint must stay
  restorable and ``LATEST`` must keep resolving.
- :class:`Straggler` — a slow host.  ``step_time`` inflates the
  *reported* step duration (no sleeping) so the
  :class:`~repro_torch.ft.health.HealthMonitor` walks its real
  CHECKPOINT_NOW -> RESTART escalation deterministically.

:class:`DeviceJoin` is the recovery-side trigger: a lost device comes
back, ``should_yield`` tells the driver to checkpoint and hand control
back so the elastic loop can warm-restart scaled back up to P.

**Serving-shaped faults** key on the engine's pipeline *tick* instead
of the training step — the reference's serving tick loop
(``PipelinedEngine.serve``; the port's engine gains it with resilient
serving) calls the mirrored seams ``on_tick_start`` / ``on_tick_end`` /
``tick_time`` / ``take_slot_corruption``:

- :class:`TickDeviceLoss` — a pipeline stage dies at a tick boundary
  (raised from ``on_tick_start`` before the tick runs);
  the reference's ``serve_resilient`` recovers at P-1.
- :class:`SlotCorruption` — one request slot's KV/SSM cache turns to
  garbage at the end of a tick (``take_slot_corruption`` hands the slot
  to the driver, which scribbles the cache and re-admits the victim via
  re-prefill).
- :class:`HungTick` — a pipeline revolution never completes; the fake
  clock jumps past the armed watchdog's timeout and the check converts
  the hang into a :class:`DeviceLossError` (kind ``hung_tick``).
- :class:`StragglerTicks` — ``tick_time`` inflates reported tick
  durations so the :class:`~repro_torch.ft.health.HealthMonitor` sees a
  persistent straggler without real waiting.

Every fault fires exactly once (at its ``step`` / ``tick``); an
injector replayed over the same schedule produces the same events.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence


class DeviceLossError(RuntimeError):
    """A pipeline stage (device) became unreachable.

    ``device`` is the *global* device index; ``kind`` records how the
    loss was detected (``device_loss`` = failed collective at step
    start, ``hung_collective`` = watchdog timeout mid-step)."""

    def __init__(self, device: int, kind: str = "device_loss",
                 step: Optional[int] = None):
        super().__init__(f"{kind}: device {device}"
                         + (f" at step {step}" if step is not None else ""))
        self.device = device
        self.kind = kind
        self.step = step
        import time
        self.raised_at = time.time()    # detect-latency anchor


class InjectedCheckpointCrash(OSError):
    """The fault-injected checkpoint writer 'died' here."""


@dataclass(frozen=True)
class DeviceLoss:
    """Device ``device`` fails just before running ``step``."""
    step: int
    device: int


@dataclass(frozen=True)
class DeviceJoin:
    """Device ``device`` (re)joins the pool before running ``step`` —
    the driver should checkpoint, yield, and warm-restart scaled up."""
    step: int
    device: int


@dataclass(frozen=True)
class HungCollective:
    """During ``step``, device ``device`` stops responding; the hang is
    noticed ``hang_s`` fake-seconds later (must exceed the watchdog
    timeout for the loss to be detected)."""
    step: int
    device: int
    hang_s: float = 600.0


@dataclass(frozen=True)
class CheckpointCrash:
    """The checkpoint write issued at ``step`` dies: ``at='bytes'``
    truncates the first leaf file at ``offset`` bytes then raises;
    ``at='rename'`` completes the tmp-dir write but dies before the
    atomic ``os.rename`` publishes it."""
    step: int
    at: str = "rename"              # "bytes" | "rename"
    offset: int = 0


@dataclass(frozen=True)
class Straggler:
    """Steps ``[step, step + n_steps)`` report ``factor`` x their real
    duration to the health monitor (simulated slow host; no sleeping)."""
    step: int
    n_steps: int = 3
    factor: float = 10.0


# -- serving-shaped faults (tick-keyed) ---------------------------------


@dataclass(frozen=True)
class TickDeviceLoss:
    """Pipeline stage ``device`` dies at the boundary of serving tick
    ``tick`` (before the tick runs).  ``device`` is the global device
    index; ``-1`` = unknown peer (the recovery loop drops the last
    survivor)."""
    tick: int
    device: int = -1


@dataclass(frozen=True)
class SlotCorruption:
    """Request slot ``slot``'s cache becomes garbage at the end of tick
    ``tick`` (flipped bits / evicted page).  The victim request's KV is
    gone — it must be re-admitted via re-prefill from the prompt."""
    tick: int
    slot: int


@dataclass(frozen=True)
class HungTick:
    """Serving tick ``tick`` never completes on device ``device``; the
    hang is noticed ``hang_s`` fake-seconds later (must exceed the
    watchdog timeout for the loss to be detected)."""
    tick: int
    device: int = -1
    hang_s: float = 600.0


@dataclass(frozen=True)
class StragglerTicks:
    """Ticks ``[tick, tick + n_ticks)`` report ``factor`` x their real
    duration to the health monitor (slow stage; no sleeping)."""
    tick: int
    n_ticks: int = 5
    factor: float = 10.0


class FaultInjector:
    """Deterministic, step-keyed fault schedule for one training run.

    The driver calls ``on_step_start`` / ``on_step_end`` / ``step_time``
    / ``should_yield`` at fixed points; ``clock`` is handed to the
    :class:`~repro_torch.ft.health.Watchdog` so hung-collective detection
    needs no wall-clock sleeping.  Faults fire once and are remembered
    across incarnations (the injector outlives driver restarts)."""

    def __init__(self, faults: Sequence[object] = ()):
        self.faults = list(faults)
        self._fired: set = set()
        self._now = 0.0
        self._rejoined: List[int] = []
        self.events: List[dict] = []    # fired-fault log, for tests

    # -- fake monotonic clock (Watchdog seam) ---------------------------
    def clock(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        self._now += seconds

    # -- step-loop seams ------------------------------------------------
    def _take(self, kind, at, attr="step"):
        for i, f in enumerate(self.faults):
            if i not in self._fired and isinstance(f, kind) \
                    and getattr(f, attr) <= at:
                self._fired.add(i)
                self.events.append({attr: at, "fault": f})
                return f
        return None

    def on_step_start(self, step: int) -> None:
        """Raises :class:`DeviceLossError` when a device-loss fault is
        due (a failed collective would surface here)."""
        f = self._take(DeviceLoss, step)
        if f is not None:
            raise DeviceLossError(f.device, "device_loss", step)

    def on_step_end(self, step: int, watchdog=None) -> None:
        """Hung-collective seam: advances the fake clock past the armed
        watchdog's timeout and converts the hang into a
        :class:`DeviceLossError`."""
        self._now += 1e-3               # healthy steps take ~1ms fake time
        f = self._take(HungCollective, step)
        if f is None:
            return
        self._now += f.hang_s
        if watchdog is None or watchdog.check():
            raise DeviceLossError(f.device, "hung_collective", step)

    def step_time(self, step: int, dt: float) -> float:
        """Reported (possibly straggler-inflated) step duration."""
        for i, f in enumerate(self.faults):
            if isinstance(f, Straggler) and \
                    f.step <= step < f.step + f.n_steps:
                self._fired.add(i)
                return dt * f.factor
        return dt

    def should_yield(self, step: int) -> bool:
        """True when a :class:`DeviceJoin` is due: the driver should
        checkpoint and return so the elastic loop can scale back up."""
        f = self._take(DeviceJoin, step)
        if f is not None:
            self._rejoined.append(f.device)
            return True
        return False

    def take_rejoined(self) -> List[int]:
        out, self._rejoined = self._rejoined, []
        return out

    # -- serving tick-loop seams ----------------------------------------
    def on_tick_start(self, tick: int) -> None:
        """Raises :class:`DeviceLossError` when a
        :class:`TickDeviceLoss` is due — the serving mirror of
        ``on_step_start`` (a failed collective would surface at the
        tick boundary)."""
        f = self._take(TickDeviceLoss, tick, attr="tick")
        if f is not None:
            raise DeviceLossError(f.device, "device_loss", tick)

    def on_tick_end(self, tick: int, watchdog=None) -> None:
        """Hung-revolution seam: advances the fake clock past the armed
        watchdog's timeout and converts the hang into a
        :class:`DeviceLossError` (kind ``hung_tick``)."""
        self._now += 1e-4           # healthy ticks take ~0.1ms fake time
        f = self._take(HungTick, tick, attr="tick")
        if f is None:
            return
        self._now += f.hang_s
        if watchdog is None or watchdog.check():
            raise DeviceLossError(f.device, "hung_tick", tick)

    def take_slot_corruption(self, tick: int) -> Optional[int]:
        """The slot whose cache turns to garbage at the end of ``tick``
        (None when no :class:`SlotCorruption` is due).  The driver
        scribbles the slot cache and re-admits the victim request."""
        f = self._take(SlotCorruption, tick, attr="tick")
        return None if f is None else f.slot

    def tick_time(self, tick: int, dt: float) -> float:
        """Reported (possibly straggler-inflated) tick duration."""
        for i, f in enumerate(self.faults):
            if isinstance(f, StragglerTicks) and \
                    f.tick <= tick < f.tick + f.n_ticks:
                self._fired.add(i)
                return dt * f.factor
        return dt

    # -- checkpoint-writer seam -----------------------------------------
    def arm_checkpoint_crash(self, step: int) -> None:
        """Install the one-shot crashing write/rename patch if a
        :class:`CheckpointCrash` is due at ``step``.  Called by the
        driver right before it issues a save; the patch removes itself
        after firing, so the driver's retry lands durably."""
        f = self._take(CheckpointCrash, step)
        if f is not None:
            install_checkpoint_crash(at=f.at, offset=f.offset)


def install_checkpoint_crash(at: str = "rename", offset: int = 0) -> None:
    """One-shot patch over :mod:`repro_torch.ft.checkpoint`'s write seams.

    ``at='bytes'``: the next leaf write stops after ``offset`` bytes and
    raises.  ``at='rename'``: the next *checkpoint-dir* rename (tmp ->
    step_<n>; the LATEST pointer rename is left alone) raises, leaving
    the fully-written tmp dir unpublished.  Either way the patch
    restores the original seam before raising, so subsequent saves
    succeed."""
    from repro_torch.ft import checkpoint as C

    if at == "bytes":
        orig = C._write_file

        def bomb_write(path, data):
            C._write_file = orig
            with open(path, "wb") as f:
                f.write(data[:offset])
            raise InjectedCheckpointCrash(
                f"injected writer death at byte {offset} of {path}")

        C._write_file = bomb_write
    elif at == "rename":
        orig_rename = C._rename

        def bomb_rename(src, dst):
            if "step_" not in str(dst):
                return orig_rename(src, dst)
            C._rename = orig_rename
            raise InjectedCheckpointCrash(
                f"injected writer death before rename -> {dst}")

        C._rename = bomb_rename
    else:
        raise ValueError(f"unknown crash point {at!r}")
