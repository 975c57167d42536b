"""Additional-data interface (paper §3 "Additional data").

Lets users feed extra system state (power, energy, temperature, failures)
into the dispatcher loop: each object is called at every event point with
the event manager and may deposit values into ``event_manager`` views or
its own state, which advanced dispatchers can read.
"""
from __future__ import annotations

import abc
from typing import Dict, List

from .events import EventManager


class AdditionalData(abc.ABC):
    """Hook object passed to ``Simulator.start_simulation(additional_data=[...])``."""

    name: str = "additional-data"

    @abc.abstractmethod
    def update(self, event_manager: EventManager) -> Dict[str, object]:
        """Called once per event point; returns a dict merged into the
        system-status view under ``self.name``."""

    def next_event_time(self):
        """Optional: next time this source needs the simulator to wake up
        (e.g. a failure injection); None if passive."""
        return None


class PowerModel(AdditionalData):
    """Simple per-resource-type power model (W per busy unit + idle floor).

    Enables energy/power-aware dispatchers, the paper's flagship example of
    additional data.
    """

    name = "power"

    def __init__(self, watts_per_unit: Dict[str, float], idle_node_watts: float = 50.0):
        self.watts = watts_per_unit
        self.idle = idle_node_watts
        self.energy_joules = 0.0
        self._last_t = None

    def update(self, em: EventManager) -> Dict[str, object]:
        rm = em.rm
        used = (rm.capacity - rm.available).sum(axis=0)  # per resource type
        power = self.idle * rm.n_nodes
        for i, rt in enumerate(rm.resource_types):
            power += self.watts.get(rt, 0.0) * float(used[i])
        if self._last_t is not None:
            self.energy_joules += power * max(em.current_time - self._last_t, 0)
        self._last_t = em.current_time
        return {"power_watts": power, "energy_joules": self.energy_joules}


class NodeFailureModel(AdditionalData):
    """Deterministic failure/repair trace injection (fault-resilience hook).

    ``events`` is a list of (time, node_id, kind) with kind in
    {"fail", "repair"}.  On failure the node's availability is zeroed (and
    running jobs on it are re-queued by the simulator); on repair capacity
    is restored.  Used by the cluster fusion layer (DESIGN.md §7).
    """

    name = "failures"

    def __init__(self, events: List) -> None:
        self.events = sorted(events)
        self._cursor = 0
        self.failed_nodes: set = set()
        self.requeued_jobs = 0

    def next_event_time(self):
        if self._cursor < len(self.events):
            return self.events[self._cursor][0]
        return None

    def pending(self, now: int):
        out = []
        while self._cursor < len(self.events) and self.events[self._cursor][0] <= now:
            out.append(self.events[self._cursor])
            self._cursor += 1
        return out

    def update(self, em: EventManager) -> Dict[str, object]:
        for _, node, kind in self.pending(em.current_time):
            if kind == "fail" and node not in self.failed_nodes:
                self.failed_nodes.add(node)
                # re-queue running jobs touching this node (release +
                # completion-event cancellation handled by the manager)
                table = em.table
                victims = [row for row in em.running_rows()
                           if node in table.assigned(int(row))]
                for row in victims:
                    em.requeue_job(table.view(int(row)))
                    self.requeued_jobs += 1
                em.rm.available[node, :] = 0
                em.rm.capacity[node, :] = 0
            elif kind == "repair" and node in self.failed_nodes:
                self.failed_nodes.discard(node)
                # restore pristine capacity for the node's group
                # (capacity was zeroed on failure; rebuild from config group)
                em.rm.capacity[node, :] = self._orig_caps[node]
                em.rm.available[node, :] = self._orig_caps[node]
        return {"failed_nodes": sorted(self.failed_nodes),
                "requeued_jobs": self.requeued_jobs}

    def bind(self, rm) -> "NodeFailureModel":
        """Capture pristine capacities before any failure mutates them."""
        self._orig_caps = rm.capacity.copy()
        return self
