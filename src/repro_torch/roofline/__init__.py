"""Roofline of the port's steps on an H100 (counterpart of
``repro.roofline``): the reference's exports, with the work counted by
:func:`count_work` and each kernel's by :func:`kernel_cost` where the
reference parses HLO (there is no ``parse_collectives``: on one card the
collective bytes are the boundary payloads the task table sends across
virtual stages, :func:`repro_torch.launch.dryrun.collective_stats`)."""
from repro_torch.roofline.analysis import (CollectiveStats, Roofline,  # noqa: F401
                                           WorkCount, cost_to_roofline,
                                           count_work, kernel_cost, mfu,
                                           model_flops_for)
