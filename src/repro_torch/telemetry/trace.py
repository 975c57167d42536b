"""TelemetryTrace — the engine-neutral telemetry schema (DESIGN.md §10).

One trace = one simulation's observability output, downsampled at a
fixed *event stride*:

* **sample matrix** ``samples [S, 5 + R]`` (int64) — one row per sampled
  event point, columns ``(t, queue, running, started_cum, requeued_cum,
  free_<rt_0>, ..., free_<rt_{R-1}>)``:

  - ``t``              simulation time of the event;
  - ``queue``          queued jobs after the event's dispatch round;
  - ``running``        running jobs after the event;
  - ``started_cum``    cumulative job starts (a requeued victim's
                       restart counts again — ``started_cum`` is the
                       total number of start decisions ever executed);
  - ``requeued_cum``   cumulative failure-preemption requeues;
  - ``free_<rt>``      free units of resource type ``rt`` summed over
                       all nodes.

  Stride semantics (both engines, pinned by the parity tests): event
  indices are 0-based and an event is sampled iff ``index % stride ==
  0`` — the FIRST event is always recorded — plus one final end-of-sim
  sample when the last event's index was not on the stride.

* **phase counters** — per-phase trip totals of the dispatch machinery
  (:data:`PHASE_KEYS`): greedy dispatch probes, EBF shadow-walk
  release iterations, backfill admissions, backfill misfit skips, and
  failure-drain trips.  Counted identically by the host planners and
  the compiled engine, so a trace finally *explains* where an EBF lane
  spends its trips instead of leaving one aggregate wall number.

The JSONL structured-trace format is self-describing: a ``header``
line carrying engine/name/stride/resource-types/capacity/phase
counters, then one ``sample`` line per row.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: fixed leading columns of the sample matrix (then one free_<rt> per type)
BASE_COLUMNS: Tuple[str, ...] = ("t", "queue", "running", "started_cum",
                                 "requeued_cum")

#: per-phase profile counter keys, in canonical order
PHASE_KEYS: Tuple[str, ...] = ("dispatch_trips", "shadow_trips",
                               "backfill_admits", "misfit_skips",
                               "fail_drain_trips")


def telemetry_columns(resource_types: Sequence[str]) -> Tuple[str, ...]:
    """Full column tuple for a system with these resource types."""
    return BASE_COLUMNS + tuple(f"free_{rt}" for rt in resource_types)


def zero_phase_counters() -> Dict[str, int]:
    return {k: 0 for k in PHASE_KEYS}


@dataclass(frozen=True)
class TelemetryTrace:
    """One simulation's decoded telemetry (engine-neutral)."""

    engine: str                       # "host" | "fleet"
    name: str                         # simulation / grid-point name
    stride: int                       # event sampling stride (>= 1)
    resource_types: Tuple[str, ...]
    samples: np.ndarray               # int64 [S, 5 + R]
    phase_counters: Dict[str, int] = field(default_factory=zero_phase_counters)
    capacity: Dict[str, int] = field(default_factory=dict)  # rt -> units
    truncated: bool = False           # device buffer overflowed

    # ------------------------------------------------------------------
    def __post_init__(self):
        want = len(telemetry_columns(self.resource_types))
        s = np.asarray(self.samples, dtype=np.int64)
        if s.ndim != 2 or s.shape[1] != want:
            raise ValueError(
                f"sample matrix shape {s.shape} != [S, {want}] for "
                f"resource types {self.resource_types}")
        object.__setattr__(self, "samples", s)
        pc = zero_phase_counters()
        pc.update({k: int(v) for k, v in self.phase_counters.items()})
        object.__setattr__(self, "phase_counters", pc)

    # ------------------------------------------------------------------
    @property
    def columns(self) -> Tuple[str, ...]:
        return telemetry_columns(self.resource_types)

    @property
    def n_samples(self) -> int:
        return int(self.samples.shape[0])

    def column(self, name: str) -> np.ndarray:
        return self.samples[:, self.columns.index(name)]

    @property
    def times(self) -> np.ndarray:
        return self.column("t")

    @property
    def queue_depth(self) -> np.ndarray:
        return self.column("queue")

    @property
    def running(self) -> np.ndarray:
        return self.column("running")

    def free(self, rt: str) -> np.ndarray:
        return self.column(f"free_{rt}")

    def utilization(self, rt: str) -> np.ndarray:
        """Fraction of resource ``rt`` in use per sample (0.0 when the
        system has no capacity of that type)."""
        cap = int(self.capacity.get(rt, 0))
        if cap <= 0:
            return np.zeros(self.n_samples, dtype=np.float64)
        return (cap - self.free(rt)) / float(cap)

    # ------------------------------------------------------------------
    def as_dict(self) -> Dict[str, object]:
        return {
            "engine": self.engine,
            "name": self.name,
            "stride": self.stride,
            "resource_types": list(self.resource_types),
            "capacity": {k: int(v) for k, v in self.capacity.items()},
            "n_samples": self.n_samples,
            "truncated": self.truncated,
            "phase_counters": dict(self.phase_counters),
            "columns": list(self.columns),
        }

    # ------------------------------------------------------------------
    def write_jsonl(self, path: str) -> str:
        """Structured-trace JSONL: one self-describing header line, then
        one ``sample`` line per row (free units as a per-type map)."""
        rts = self.resource_types
        with open(path, "w") as fh:
            fh.write(json.dumps({"kind": "header", **self.as_dict()}) + "\n")
            for row in self.samples:
                rec = {"kind": "sample"}
                rec.update({c: int(v) for c, v in zip(BASE_COLUMNS, row)})
                rec["free"] = {rt: int(row[len(BASE_COLUMNS) + i])
                               for i, rt in enumerate(rts)}
                fh.write(json.dumps(rec) + "\n")
        return path

    # ------------------------------------------------------------------
    @classmethod
    def read_jsonl(cls, path: str) -> "TelemetryTrace":
        header: Optional[Dict] = None
        rows: List[List[int]] = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("kind") == "header":
                    header = rec
                elif rec.get("kind") == "sample":
                    if header is None:
                        raise ValueError(f"{path}: sample before header")
                    rows.append([rec[c] for c in BASE_COLUMNS]
                                + [rec["free"][rt]
                                   for rt in header["resource_types"]])
        if header is None:
            raise ValueError(f"{path}: no telemetry header line")
        rts = tuple(header["resource_types"])
        samples = (np.asarray(rows, dtype=np.int64) if rows
                   else np.zeros((0, len(telemetry_columns(rts))),
                                 dtype=np.int64))
        return cls(engine=header["engine"], name=header["name"],
                   stride=int(header["stride"]), resource_types=rts,
                   samples=samples,
                   phase_counters=header.get("phase_counters", {}),
                   capacity=header.get("capacity", {}),
                   truncated=bool(header.get("truncated", False)))

    # ------------------------------------------------------------------
    def assert_parity(self, other: "TelemetryTrace") -> None:
        """Raise AssertionError unless ``other`` carries bit-identical
        samples and phase-counter totals (the host-vs-fleet contract)."""
        assert self.resource_types == other.resource_types, \
            (self.resource_types, other.resource_types)
        assert self.stride == other.stride, (self.stride, other.stride)
        assert self.samples.shape == other.samples.shape, \
            (self.samples.shape, other.samples.shape)
        if not np.array_equal(self.samples, other.samples):
            bad = np.nonzero((self.samples != other.samples).any(axis=1))[0]
            i = int(bad[0])
            raise AssertionError(
                f"telemetry sample divergence at row {i}: "
                f"{self.samples[i].tolist()} != {other.samples[i].tolist()} "
                f"(columns {self.columns})")
        assert self.phase_counters == other.phase_counters, \
            (self.phase_counters, other.phase_counters)
