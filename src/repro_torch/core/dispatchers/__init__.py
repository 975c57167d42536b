from .context import (DispatchContext, DispatchPlan, ReleaseEvent,
                      context_from_arrays)
from .base import AllocatorBase, SchedulerBase, Dispatcher
from .allocators import FirstFit, BestFit
from .schedulers import (
    FirstInFirstOut,
    ShortestJobFirst,
    LongestJobFirst,
    EasyBackfilling,
    RejectAll,
)
from .advanced import (
    PriorityAging,
    WalltimeCorrectedEBF,
    EnergyCappedScheduler,
)

# NOTE: the vectorized engine (BatchProbe, VectorizedAllocator,
# VectorizedEasyBackfilling) lives in ``.vectorized`` and is imported
# explicitly by its users — pulling it in here would make every
# numpy-only simulation pay the torch import cost.

__all__ = [
    "DispatchContext",
    "DispatchPlan",
    "ReleaseEvent",
    "context_from_arrays",
    "AllocatorBase",
    "SchedulerBase",
    "Dispatcher",
    "FirstFit",
    "BestFit",
    "FirstInFirstOut",
    "ShortestJobFirst",
    "LongestJobFirst",
    "EasyBackfilling",
    "RejectAll",
    "PriorityAging",
    "WalltimeCorrectedEBF",
    "EnergyCappedScheduler",
]
