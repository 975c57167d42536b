"""Automated plot generation (paper §3 "Tools", Fig. 4 usage).

    pf = PlotFactory('decision', sys_cfg)
    pf.set_files([out1, out2], labels=['FIFO-FF', 'EBF-BF'])
    pf.produce_plot('slowdown')          # box-and-whisker, paper Fig. 10

Plot types:
  decision-related:    slowdown | queue_size | waiting_time | utilization
  performance-related: dispatch_time | dispatch_vs_queue | memory
  telemetry-related:   telemetry_utilization | telemetry_queue
                       (the DESIGN.md §10 structured traces — identical
                       series whichever engine produced the JSONL)

Headless (Agg) — each call writes a PNG next to the first input file.
matplotlib is imported by the calls that draw, not with the module, so
the rest of the experimentation layer runs where it is not installed;
there a plot call raises ``ImportError``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

from . import metrics

DECISION_PLOTS = ("slowdown", "queue_size", "waiting_time", "utilization")
PERFORMANCE_PLOTS = ("dispatch_time", "dispatch_vs_queue", "memory")
TELEMETRY_PLOTS = ("telemetry_utilization", "telemetry_queue")


def _pyplot():
    """``matplotlib.pyplot`` on the headless Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def utilization_heatmap(output_path: str, n_nodes: int, out_png: str,
                        time_bins: int = 200):
    """Node × time allocation heatmap — headless stand-in for the paper's
    GUI system-visualization (Fig. 9).  Reads per-job records."""
    import json

    import numpy as np
    plt = _pyplot()
    jobs = []
    t_max = 1
    with open(output_path) as fh:
        for line in fh:
            r = json.loads(line)
            if r.get("start") is None or r.get("end") is None:
                continue
            jobs.append(r)
            t_max = max(t_max, r["end"])
    grid = np.zeros((n_nodes, time_bins), dtype=np.float32)
    scale = time_bins / t_max
    for r in jobs:
        b0 = int(r["start"] * scale)
        b1 = max(int(r["end"] * scale), b0 + 1)
        for node in r["assigned"]:
            if node < n_nodes:
                grid[node, b0:b1] += 1
    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(grid, aspect="auto", origin="lower", cmap="viridis")
    ax.set_xlabel(f"time (bins of {t_max/time_bins:.0f}s)")
    ax.set_ylabel("node")
    fig.colorbar(im, ax=ax, label="jobs on node")
    ax.set_title("system utilization (paper Fig. 9)")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png


class PlotFactory:
    def __init__(self, plot_group: str = "decision",
                 sys_config: Optional[Dict] = None) -> None:
        if plot_group not in ("decision", "performance", "telemetry"):
            raise ValueError(plot_group)
        self.plot_group = plot_group
        self.sys_config = sys_config
        self.files: List[str] = []
        self.bench_files: List[str] = []
        self.telemetry_files: List[str] = []
        self.labels: List[str] = []

    def set_files(self, files: List[str], labels: List[str],
                  bench_files: Optional[List[str]] = None,
                  telemetry_files: Optional[List[str]] = None) -> None:
        self.files = list(files)
        self.labels = list(labels)
        self.bench_files = list(bench_files or
                                [f.replace("-output.jsonl", "-bench.jsonl")
                                 for f in files])
        self.telemetry_files = list(
            telemetry_files or
            [f.replace("-output.jsonl", "-telemetry.jsonl") for f in files])

    # ------------------------------------------------------------------
    def produce_plot(self, kind: str, out_path: Optional[str] = None) -> str:
        allowed = {"decision": DECISION_PLOTS,
                   "performance": PERFORMANCE_PLOTS,
                   "telemetry": TELEMETRY_PLOTS}[self.plot_group]
        if kind not in allowed:
            raise ValueError(f"{kind!r} not in {allowed} for group "
                             f"{self.plot_group!r}")
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(1.2 + 1.1 * len(self.labels), 4.0))
        if kind == "slowdown":
            data = [metrics.slowdowns(f) for f in self.files]
            ax.boxplot(data, tick_labels=self.labels, showfliers=False)
            ax.set_yscale("log")
            ax.set_ylabel("job slowdown")
        elif kind == "waiting_time":
            data = [metrics.waiting_times(f) for f in self.files]
            ax.boxplot(data, tick_labels=self.labels, showfliers=False)
            ax.set_ylabel("waiting time (s)")
        elif kind == "queue_size":
            data = [metrics.bench_series(b)["queue"] for b in self.bench_files]
            ax.boxplot(data, tick_labels=self.labels, showfliers=False)
            ax.set_ylabel("queue size")
        elif kind == "utilization":
            for b, lab in zip(self.bench_files, self.labels):
                s = metrics.bench_series(b)
                ax.plot(s["t"], s["running"], label=lab, linewidth=0.8)
            ax.set_xlabel("simulation time (s)")
            ax.set_ylabel("running jobs")
            ax.legend(fontsize=7)
        elif kind == "dispatch_time":
            data = [[d * 1e3 for d in metrics.bench_series(b)["dispatch_s"]]
                    for b in self.bench_files]
            ax.boxplot(data, tick_labels=self.labels, showfliers=False)
            ax.set_ylabel("dispatch CPU time / event (ms)")
        elif kind == "dispatch_vs_queue":
            for b, lab in zip(self.bench_files, self.labels):
                pts = metrics.dispatch_time_by_queue_size(b)
                ax.plot([p[0] for p in pts], [p[1] * 1e3 for p in pts],
                        marker="o", markersize=2.5, label=lab, linewidth=0.8)
            ax.set_xlabel("queue size")
            ax.set_ylabel("mean dispatch time (ms)")
            ax.legend(fontsize=7)
        elif kind == "memory":
            for b, lab in zip(self.bench_files, self.labels):
                s = metrics.bench_series(b)
                ax.plot(s["t"], s["rss_mb"], label=lab, linewidth=0.8)
            ax.set_xlabel("simulation time (s)")
            ax.set_ylabel("RSS (MB)")
            ax.legend(fontsize=7)
        elif kind == "telemetry_utilization":
            for tf, lab in zip(self.telemetry_files, self.labels):
                s = metrics.telemetry_series(tf)
                for rt, util in sorted(s["utilization"].items()):
                    ax.plot(s["t"], util, label=f"{lab}:{rt}",
                            linewidth=0.8)
            ax.set_xlabel("simulation time (s)")
            ax.set_ylabel("utilized fraction")
            ax.set_ylim(0.0, 1.05)
            ax.legend(fontsize=7)
        elif kind == "telemetry_queue":
            for tf, lab in zip(self.telemetry_files, self.labels):
                s = metrics.telemetry_series(tf)
                ax.plot(s["t"], s["queue"], label=lab, linewidth=0.8)
            ax.set_xlabel("simulation time (s)")
            ax.set_ylabel("queued jobs")
            ax.legend(fontsize=7)
        ax.set_title(kind)
        plt.xticks(rotation=30, fontsize=7)
        fig.tight_layout()
        if out_path is None:
            base = os.path.dirname(self.files[0]) if self.files else "."
            out_path = os.path.join(base, f"plot_{kind}.png")
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
        return out_path
