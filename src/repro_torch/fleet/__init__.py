"""fleet/ — the simulation engine that runs on the device (DESIGN.md §8).

Runs whole dispatcher×seed grids in one device launch: a fixed-capacity
:class:`SimState` snapshotted from the host core, an engine that runs
every event of a sim on the card (one CUDA thread block per sim,
``kernels/csrc/fleet_engine.cu``) covering FIFO/SJF/LJF/EBF ×
FirstFit/BestFit, and a :class:`FleetRunner` that stacks a leading sim
axis and splits it across devices.  ``HostSnapshot`` is the lossless
host-side export/import companion (the host-fallback contract).
"""
from .engine import (ALLOC_BF, ALLOC_FF, ALLOC_NAMES, SCHED_EBF, SCHED_FIFO,
                     SCHED_LJF, SCHED_NAMES, SCHED_SJF, advance,
                     advance_plain, alloc_code, compiles, dispatch_code,
                     sched_code, stack, unstack)
from .runner import FleetResult, FleetRunner, FleetSim
from .state import HostSnapshot, SimMeta, SimState

__all__ = [
    "SCHED_FIFO", "SCHED_SJF", "SCHED_LJF", "SCHED_EBF", "SCHED_NAMES",
    "ALLOC_FF", "ALLOC_BF", "ALLOC_NAMES",
    "advance", "advance_plain", "compiles", "sched_code", "alloc_code",
    "dispatch_code", "stack", "unstack",
    "FleetResult", "FleetRunner", "FleetSim",
    "HostSnapshot", "SimMeta", "SimState",
]
