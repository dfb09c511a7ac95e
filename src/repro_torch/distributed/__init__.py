"""Fault tolerance across steps and worker processes (torch port of
``repro.distributed.fault``)."""
from .fault import (
    ChaosReport,
    DeviceFailure,
    FailurePlan,
    Supervisor,
    SupervisorReport,
    supervise_workers,
)

__all__ = ["ChaosReport", "DeviceFailure", "FailurePlan", "Supervisor",
           "SupervisorReport", "supervise_workers"]
