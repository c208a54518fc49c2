"""Pipelined serving: slot scheduler, traffic, slot caches and the
engine (port of ``repro.serve``)."""
from repro_torch.serve.engine import PipelinedEngine, pack_blocks  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    DECODE, IDLE, IDLE_INJ, PREFILL, Injection, Request, SlotScheduler)
from repro_torch.serve.traffic import (  # noqa: F401
    percentile, poisson_requests, summarize)
