"""Fault tolerance: checkpointing, elastic re-planning, health
monitoring and deterministic fault injection (port of ``repro.ft``;
every module imports eagerly: none needs JAX).

``repro_torch.ft.elastic_pipeline`` (train_elastic / migrate_checkpoint
/ RecoveryRecord) stays an explicit submodule import, as in the
reference: it pulls in the training driver.
"""
from repro_torch.ft.checkpoint import Checkpointer  # noqa: F401
from repro_torch.ft.elastic import (ElasticDecision,  # noqa: F401
                                    MeshRequirements, plan_mesh,
                                    simulate_failures)
from repro_torch.ft.health import Action, HealthMonitor, Watchdog  # noqa: F401
from repro_torch.ft.inject import (CheckpointCrash, DeviceJoin,  # noqa: F401
                                   DeviceLoss, DeviceLossError,
                                   FaultInjector, HungCollective, HungTick,
                                   InjectedCheckpointCrash, SlotCorruption,
                                   Straggler, StragglerTicks,
                                   TickDeviceLoss)

__all__ = [
    "Action", "HealthMonitor", "Watchdog",
    "CheckpointCrash", "DeviceJoin", "DeviceLoss", "DeviceLossError",
    "FaultInjector", "HungCollective", "HungTick",
    "InjectedCheckpointCrash", "SlotCorruption", "Straggler",
    "StragglerTicks", "TickDeviceLoss",
    "Checkpointer", "ElasticDecision", "MeshRequirements", "plan_mesh",
    "simulate_failures",
]
