"""Paper Figs 14-17: workload-generator fidelity — hourly/daily
submission-cycle correlation and theoretical-GFLOP distribution match
between a real-like trace and its generated mimic.

Host only.  The figure needs matplotlib, imported at the plot step: where
it is not installed, ``run`` raises ``ImportError`` there."""
from __future__ import annotations

import json
import math
import os
import time

from repro_torch.generator import WorkloadGenerator
from repro_torch.workloads import SWFWriter

from .common import SETH, emit, scaled, seth_jobs


def _hourly(ts):
    h = [0] * 24
    for t in ts:
        h[(t // 3600) % 24] += 1
    tot = max(sum(h), 1)
    return [c / tot for c in h]


def _daily(ts):
    d = [0] * 7
    for t in ts:
        d[(t // 86400) % 7] += 1
    tot = max(sum(d), 1)
    return [c / tot for c in d]


def _corr(a, b):
    ma, mb = sum(a) / len(a), sum(b) / len(b)
    num = sum((x - ma) * (y - mb) for x, y in zip(a, b))
    den = math.sqrt(sum((x - ma) ** 2 for x in a)
                    * sum((y - mb) ** 2 for y in b))
    return num / den if den else 0.0


def run(out_dir: str = "results/bench") -> dict:
    os.makedirs(out_dir, exist_ok=True)
    # "real" trace (Seth-like) -> SWF file
    real = list(seth_jobs(scaled(20_000), seed=5))
    real_swf = os.path.join(out_dir, "figgen-real.swf")
    SWFWriter().write(
        iter({"id": i + 1, "submit": j.submission_time, "duration": j.duration,
              "expected_duration": j.expected_duration,
              "requested_processors": j.requested_resources["core"]
              * j.requested_nodes,
              "requested_memory": j.requested_resources.get("mem", 0),
              "user": j.user_id, "status": 1}
             for i, j in enumerate(real)), real_swf)

    t0 = time.perf_counter()
    gen = WorkloadGenerator(real_swf, SETH, {"core": 1.667},
                            {"min": {"core": 1, "mem": 64},
                             "max": {"core": 4, "mem": 1024}}, seed=13)
    synth = gen.generate_jobs(scaled(20_000),
                              os.path.join(out_dir, "figgen-synth.swf"))
    gen_time = time.perf_counter() - t0

    real_ts = [j.submission_time for j in real]
    syn_ts = [j["submit"] for j in synth]
    hc = _corr(_hourly(real_ts), _hourly(syn_ts))
    dc = _corr(_daily(real_ts), _daily(syn_ts))

    # GFLOP distribution (paper Figs 16/17): compare log-space moments
    core_perf = 1.667
    real_work = [math.log(max(j.duration, 1) * j.requested_resources["core"]
                          * j.requested_nodes * core_perf) for j in real]
    syn_work = [math.log(j["work_gflop"]) for j in synth]
    mr = sum(real_work) / len(real_work)
    ms = sum(syn_work) / len(syn_work)
    sr = math.sqrt(sum((x - mr) ** 2 for x in real_work) / len(real_work))
    ss = math.sqrt(sum((x - ms) ** 2 for x in syn_work) / len(syn_work))

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    axes[0].plot(_hourly(real_ts), label="real")
    axes[0].plot(_hourly(syn_ts), label="generated")
    axes[0].set_title(f"hourly cycle (corr={hc:.2f})")
    axes[0].legend(fontsize=7)
    axes[1].plot(_daily(real_ts), label="real")
    axes[1].plot(_daily(syn_ts), label="generated")
    axes[1].set_title(f"daily cycle (corr={dc:.2f})")
    axes[2].hist(real_work, bins=40, alpha=0.5, density=True, label="real")
    axes[2].hist(syn_work, bins=40, alpha=0.5, density=True, label="generated")
    axes[2].set_title("log GFLOP distribution")
    axes[2].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "fig_generator.png"), dpi=110)
    plt.close(fig)

    out = {"hourly_corr": round(hc, 3), "daily_corr": round(dc, 3),
           "work_logmean_real": round(mr, 3), "work_logmean_gen": round(ms, 3),
           "work_logstd_real": round(sr, 3), "work_logstd_gen": round(ss, 3),
           "gen_us_per_job": 1e6 * gen_time / len(synth)}
    emit("fig_generator/gen", out["gen_us_per_job"],
         f"hourly_corr={hc:.2f};daily_corr={dc:.2f}")
    with open(os.path.join(out_dir, "fig_generator.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    print(json.dumps(run(), indent=1))
