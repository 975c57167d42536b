"""Kernel-launch accounting — dependency-free on purpose.

Two counts are kept:

* ``record`` — one per public ``ops`` wrapper call, whatever device the
  call ran on (the plain PyTorch version on the CPU stands in for the
  kernel, so it costs a dispatch all the same).  The dispatch layer
  (``Dispatcher.plan``) snapshots the totals around each planning call to
  stamp ``DispatchPlan.stats["kernel_launches"]``.
* ``record_device`` — one per CUDA kernel launch, counted by the kernel
  wrapper right after its launch succeeded and nowhere else.  It proves
  that a run on the card went through the hand-written kernels.

Living outside ``ops.py`` keeps the counters importable by numpy-only
code paths without paying the torch import.
"""
from __future__ import annotations

from typing import Dict

_launches: Dict[str, int] = {}
_device_launches: Dict[str, int] = {}


def record(name: str) -> None:
    """Count one launch of kernel ``name``."""
    _launches[name] = _launches.get(name, 0) + 1


def launch_count() -> int:
    """Total kernel-layer launches since process start (monotone)."""
    return sum(_launches.values())


def launch_stats() -> Dict[str, int]:
    """Per-op launch counters (copy; monotone since process start)."""
    return dict(_launches)


def record_device(name: str) -> None:
    """Count one CUDA launch of kernel ``name``."""
    _device_launches[name] = _device_launches.get(name, 0) + 1


def device_launch_stats() -> Dict[str, int]:
    """Per-kernel CUDA launch counters since the last reset (copy)."""
    return dict(_device_launches)


def reset_device_launches() -> None:
    """Set every CUDA launch counter to 0."""
    _device_launches.clear()
