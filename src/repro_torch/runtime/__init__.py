"""The training runtime: checkpoint/restart, fault injection and the
straggler watchdog (the counterparts of ``repro.runtime.fault_tolerance``;
compression and elastic re-meshing wait for the port's mesh)."""
from repro_torch.runtime.fault_tolerance import (
    InjectedFault,
    RunReport,
    StragglerAlert,
    TrainRunner,
)

__all__ = ["InjectedFault", "RunReport", "StragglerAlert", "TrainRunner"]
