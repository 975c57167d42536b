"""Standard Workload Format (SWF) reader/writer [Feitelson et al. 2014].

SWF is line-oriented: 18 whitespace-separated integer fields per job,
``;``-prefixed header/comment lines.  The reader streams records lazily
(incremental loading) and performs the same light preprocessing the paper
describes for AccaSim/Alea: records with non-positive runtimes or
processor counts are dropped during submission (counted, not buffered).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

from .reader import Reader, WorkloadWriter

# SWF field indices (0-based)
_JOB, _SUBMIT, _WAIT, _RUN, _ALLOC_P, _AVG_CPU, _USED_MEM, _REQ_P, _REQ_T, \
    _REQ_MEM, _STATUS, _USER, _GROUP, _APP, _QUEUE, _PART, _PREC, _THINK = range(18)


class SWFReader(Reader):
    def __init__(self, path: str, max_jobs: Optional[int] = None) -> None:
        self.path = path
        self.max_jobs = max_jobs
        self.header: Dict[str, str] = {}
        self.skipped = 0

    def __iter__(self) -> Iterator[Dict[str, object]]:
        yielded = 0
        self.skipped = 0
        with open(self.path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                if line.startswith(";"):
                    if ":" in line:
                        key, _, val = line[1:].partition(":")
                        self.header[key.strip()] = val.strip()
                    continue
                parts = line.split()
                if len(parts) < 5:
                    self.skipped += 1
                    continue
                try:
                    f = [int(float(x)) for x in parts[:18]]
                except ValueError:
                    self.skipped += 1
                    continue
                while len(f) < 18:
                    f.append(-1)
                run = f[_RUN]
                procs = f[_REQ_P] if f[_REQ_P] > 0 else f[_ALLOC_P]
                if run < 0 or procs <= 0 or f[_SUBMIT] < 0:
                    self.skipped += 1
                    continue
                rec = {
                    "id": f[_JOB],
                    "submit": f[_SUBMIT],
                    "duration": run,
                    "expected_duration": f[_REQ_T] if f[_REQ_T] > 0 else run,
                    "requested_processors": procs,
                    "requested_memory": max(f[_REQ_MEM] if f[_REQ_MEM] > 0 else f[_USED_MEM], 0),
                    "user": f[_USER],
                    "status": f[_STATUS],
                }
                yield rec
                yielded += 1
                if self.max_jobs is not None and yielded >= self.max_jobs:
                    return


class SWFWriter(WorkloadWriter):
    HEADER = [
        "; SWF written by repro_torch.workloads.swf.SWFWriter",
        "; UnixStartTime: 0",
    ]

    def write(self, records, path: str) -> int:
        n = 0
        with open(path, "w") as fh:
            for line in self.HEADER:
                fh.write(line + "\n")
            for rec in records:
                f = [-1] * 18
                f[_JOB] = int(rec["id"])
                f[_SUBMIT] = int(rec["submit"])
                f[_RUN] = int(rec["duration"])
                f[_ALLOC_P] = int(rec.get("requested_processors", 1))
                f[_REQ_P] = int(rec.get("requested_processors", 1))
                f[_REQ_T] = int(rec.get("expected_duration", rec["duration"]))
                f[_REQ_MEM] = int(rec.get("requested_memory", -1))
                f[_USER] = int(rec.get("user", -1))
                f[_STATUS] = int(rec.get("status", 1))
                fh.write(" ".join(str(x) for x in f) + "\n")
                n += 1
        return n
