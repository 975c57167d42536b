"""Allocators: First-Fit and Best-Fit (paper §3 "Dispatcher").

* First-Fit (FF): the first ``n`` nodes (by node id) whose availability
  covers the per-node request.
* Best-Fit (BF): nodes sorted by current load, busiest first (ties by node
  id), to pack jobs onto already-busy nodes and reduce fragmentation.

Both have a pure-numpy implementation here (the reference semantics) and a
vectorized CUDA twin in ``vectorized.py`` validated against this one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .base import AllocatorBase


class FirstFit(AllocatorBase):
    name = "FF"

    def find_nodes(self, request_vec, n_nodes, avail, capacity):
        mask = np.all(avail >= request_vec[None, :], axis=1)
        idx = np.nonzero(mask)[0]
        if idx.shape[0] < n_nodes:
            return None
        return idx[:n_nodes]


class BestFit(AllocatorBase):
    name = "BF"

    def find_nodes(self, request_vec, n_nodes, avail, capacity):
        mask = np.all(avail >= request_vec[None, :], axis=1)
        if int(mask.sum()) < n_nodes:
            return None
        cap = np.maximum(capacity, 1)
        load = ((capacity - avail) / cap).sum(axis=1)
        # busiest first; ties broken by node id (stable sort on -load)
        order = np.argsort(-load, kind="stable")
        fitting = order[mask[order]]
        return fitting[:n_nodes]
