"""Pipelined serving: slot scheduler, traffic, slot caches, the engine and
the resilient serving loop (port of ``repro.serve``)."""
from repro_torch.serve.engine import (PipelinedEngine,  # noqa: F401
                                      new_telemetry, pack_blocks)
from repro_torch.serve.resilience import (ServeRecovery,  # noqa: F401
                                          parse_fault_spec, serve_resilient)
from repro_torch.serve.scheduler import (  # noqa: F401
    COMPLETED, DECODE, EXPIRED, FAILED, IDLE, IDLE_INJ, PREFILL, SHED,
    TERMINAL_STATES, DroppedRecord, FinishedRecord, Injection, Request,
    SlotScheduler, prefill_injection_order)
from repro_torch.serve.traffic import (  # noqa: F401
    bursty_requests, percentile, poisson_requests, summarize)

__all__ = [
    "COMPLETED", "DECODE", "EXPIRED", "FAILED", "IDLE", "IDLE_INJ",
    "PREFILL", "SHED", "TERMINAL_STATES", "DroppedRecord",
    "FinishedRecord", "Injection", "Request", "SlotScheduler",
    "prefill_injection_order",
    "ServeRecovery", "parse_fault_spec", "serve_resilient",
    "bursty_requests", "percentile", "poisson_requests", "summarize",
    "PipelinedEngine", "new_telemetry", "pack_blocks",
]
