"""telemetry/ — ONE observability layer across both engines (DESIGN.md §10).

The paper's §3 "Tools" pitch — live system status, utilization
monitoring, simulator-performance tracking — is honored by BOTH engines
through a single schema:

* the host :class:`~repro_torch.core.monitors.UtilizationMonitor` accumulates
  telemetry-schema sample rows per observed event;
* the fleet engine writes the same rows into a fixed-capacity device
  buffer inside its device loop (``SimState.tele_buf``, written by the
  ``fleet_engine`` kernel on the card), plus per-phase profile counters;
* both decode into :class:`TelemetryTrace` — a downsampled sample matrix
  ``[S, 5 + R]`` + phase-counter totals — with one JSONL structured-trace
  format (:meth:`TelemetryTrace.write_jsonl` / ``read_jsonl``) consumed
  by the metrics/plots pipeline and the benchmark profiler.

Parity contract (pinned by ``tests/test_telemetry.py``): same workload +
same stride ⇒ bit-identical sample matrices and phase-counter totals
from either engine.

The host side of the fleet path is traced by :mod:`.spans`: spans and
counters where the work happens (pad, stack, copies, unstack, summaries,
set-up), recorded in memory while tracing is on or a ``torch.profiler``
session captures, and placed on the profiler's clock as its ranges.
"""
from .trace import (BASE_COLUMNS, PHASE_KEYS, TelemetryTrace,
                    telemetry_columns)

__all__ = ["BASE_COLUMNS", "PHASE_KEYS", "TelemetryTrace",
           "telemetry_columns"]
