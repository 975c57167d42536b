"""Continuous-batching request scheduler for the serving example.

A fixed number of batch *slots* (the compiled decode batch size) are
filled from a FIFO request queue; finished or evicted requests free their
slot for the next queued request — the serving-side analogue of the
paper's queue/dispatcher loop, and the bridge to the cluster fusion layer
(a serving job's slot occupancy feeds its utilization profile).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional


@dataclass
class Request:
    id: str
    prompt: List[int]
    max_new_tokens: int
    submitted_at: float = 0.0
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False


class RequestBatcher:
    def __init__(self, n_slots: int) -> None:
        self.n_slots = n_slots
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.completed: List[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def admit(self) -> List[Request]:
        """Fill free slots from the queue; returns newly admitted requests
        (caller prefills their prompts into the paged cache)."""
        admitted = []
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                req.slot = i
                self.slots[i] = req
                admitted.append(req)
        return admitted

    def record_tokens(self, slot_tokens: Dict[int, int], eos_id: int = -1):
        """Feed one decode step's tokens; retire finished requests."""
        for slot, tok in slot_tokens.items():
            req = self.slots[slot]
            if req is None:
                continue
            req.generated.append(int(tok))
            if len(req.generated) >= req.max_new_tokens or tok == eos_id:
                req.done = True
                self.completed.append(req)
                self.slots[slot] = None

    @property
    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    @property
    def idle(self) -> bool:
        return not self.queue and not any(self.slots)
