"""The benchmark's harness: one run of one cell, driven by data.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics.  Everything that belongs to one name sits in files of its own,
found by that name:

* ``perfbench/configs/<config>.json``: the configuration (the system,
  its scale, its guarantees) and the ``entry`` that runs it;
* ``perfbench/traffic/<traffic>.json``: the traffic mix's parameters,
  read by the generator it names, ``perfbench/streams/<generator>.py``;
* ``perfbench/entries/<entry>.py``: the entry into the program a cell
  drives, how its work is counted and how its output is checked;
* ``perfbench/metrics/<metric>.py``: one reader per metric, which
  takes its number from the run's record (``read(run)``) and returns
  None where it finds nothing to read.

A new configuration, mix, entry or metric is a new file and a new item
in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
#: top-level module names the measured process may never hold: JAX and
#: the JAX package the port was made from (compared whole: the port's
#: own package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of ``modules`` (``sys.modules`` by default) that
    are JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops.intersection(FORBIDDEN))


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path = ROOT

    def file(self, *parts: str) -> Path:
        return self.root / "perfbench" / Path(*parts)

    def entry(self) -> ModuleType:
        name = self.config["entry"]
        return load_module(self.file("entries", f"{name}.py"),
                           f"perfbench_entry_{name}")

    def generator(self) -> ModuleType:
        gen = self.traffic["generator"]
        return load_module(self.file("streams", f"{gen}.py"),
                           f"perfbench_stream_{gen}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.file("metrics", f"{metric}.py"),
                           "perfbench_metric_" + metric.replace(".", "_"))


def load_spec(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def resolve(cell_name: str, root: Path = ROOT) -> Cell:
    """The cell ``cell_name`` with its configuration, traffic and the
    metrics it reports; raises KeyError for an unknown cell."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(cells))})")
    w = cells[cell_name]
    configs = {c["name"]: c for c in spec["configs"]}
    with open(root / configs[w["config"]]["file"]) as fh:
        config = json.load(fh)
    with open(root / "perfbench" / "traffic" / f"{w['traffic']}.json") as fh:
        traffic = json.load(fh)
    return Cell(name=cell_name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=spec["end_to_end"], per_layer=spec["per_layer"],
                root=root)


@dataclass
class RunRecord:
    """What one run measured; the metric readers take their numbers from
    it.  Times in seconds unless named otherwise."""

    setup_s: float = 0.0
    window_s: float = 0.0
    requests: int = 0                 # requests completed in the window
    work: int = 0                     # work units (the entry's count)
    spans: Dict[str, float] = field(default_factory=dict)
    kernels: Dict[str, List[float]] = field(default_factory=dict)  # ms
    device: Dict[str, object] = field(default_factory=dict)


def read_metrics(cell: Cell, run: RunRecord, metrics: List[Dict]) -> Dict:
    """``{name: {"value", "unit"}}`` of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
