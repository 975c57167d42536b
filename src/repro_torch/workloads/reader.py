"""Abstract workload I/O (paper Fig. 3: Reader / WorkloadWriter).

Implement ``Reader`` to ingest any workload format or source (file, DB,
socket); implement ``WorkloadWriter`` to emit generated datasets in any
format.  The SWF defaults live in ``swf.py``.
"""
from __future__ import annotations

import abc
from typing import Dict, Iterator


class Reader(abc.ABC):
    """Streams workload records as dicts, sorted by submission time.

    Must be a *lazy* iterator: the simulator's incremental loading
    guarantee (paper §3) depends on readers never materializing the whole
    dataset.
    """

    @abc.abstractmethod
    def __iter__(self) -> Iterator[Dict[str, object]]:
        ...


class WorkloadWriter(abc.ABC):
    @abc.abstractmethod
    def write(self, records: Iterator[Dict[str, object]], path: str) -> int:
        """Write records to ``path``; returns number written."""
