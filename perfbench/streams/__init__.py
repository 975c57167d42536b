"""Job-stream generators, one module a kind of stream, each with
``generate(traffic, seed, n) -> Stream``; a traffic file names its
generator under ``"generator"``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class Stream:
    """One stream's jobs as columns (row i is job ``str(i)``)."""

    submit: np.ndarray            # int64[J]
    duration: np.ndarray          # int64[J]
    expected: np.ndarray          # int64[J] walltime estimates as given
    nodes: np.ndarray             # int64[J] requested node count
    user: np.ndarray              # int64[J]
    req: Dict[str, np.ndarray]    # resource type -> int64[J] per node

    def __len__(self) -> int:
        return int(self.submit.shape[0])

    def records(self) -> List[Dict[str, object]]:
        """The jobs as workload records (what the program is handed)."""
        rts = sorted(self.req)
        cols = [self.submit.tolist(), self.duration.tolist(),
                self.expected.tolist(), self.nodes.tolist(),
                self.user.tolist()] + [self.req[rt].tolist() for rt in rts]
        return [{"id": str(i), "user": u, "submit": s, "duration": d,
                 "expected_duration": e, "requested_nodes": n,
                 "requested_resources": dict(zip(rts, r))}
                for i, (s, d, e, n, u, *r) in enumerate(zip(*cols))]
