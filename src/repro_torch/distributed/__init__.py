"""Fault tolerance across steps and worker processes, and the sharding plan
(torch port of ``repro.distributed.fault`` and ``.sharding``)."""
from .fault import (
    ChaosReport,
    DeviceFailure,
    FailurePlan,
    Supervisor,
    SupervisorReport,
    supervise_workers,
)
from .sharding import (
    LOGICAL_RULES,
    MeshShape,
    NamedSharding,
    PartitionSpec,
    batch_pspec,
    cache_pspecs,
    constrain,
    data_axes,
    param_pspecs,
    param_shardings,
)

__all__ = ["ChaosReport", "DeviceFailure", "FailurePlan", "LOGICAL_RULES",
           "MeshShape", "NamedSharding", "PartitionSpec", "Supervisor",
           "SupervisorReport", "batch_pspec", "cache_pspecs", "constrain",
           "data_axes", "param_pspecs", "param_shardings",
           "supervise_workers"]
