"""AccaSim core: the paper's primary contribution as a composable library.

Public API mirrors the paper's Fig. 4 instantiation:

    from repro_torch.core import Simulator
    from repro_torch.core.dispatchers import FirstInFirstOut, FirstFit

    sim = Simulator('workload.swf', 'sys_config.json',
                    FirstInFirstOut(FirstFit()))
    out = sim.start_simulation()
"""
from .job import Job, JobFactory, JobState, swf_resource_mapper
from .jobtable import JobTable
from .resources import ResourceManager
from .events import EventManager
from .simulator import Simulator
from .additional_data import AdditionalData, PowerModel, NodeFailureModel
from .monitors import SystemStatus, UtilizationMonitor

__all__ = [
    "Job", "JobFactory", "JobState", "JobTable", "swf_resource_mapper",
    "ResourceManager", "EventManager", "Simulator",
    "AdditionalData", "PowerModel", "NodeFailureModel",
    "SystemStatus", "UtilizationMonitor",
]
