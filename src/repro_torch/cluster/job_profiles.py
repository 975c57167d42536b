"""Architecture job profiles derived from the dry-run roofline records.

This closes the loop with the paper's workload generator (§7.3): there,
job durations come from *synthetic* theoretical FLOPs over per-unit
performance; here they come from the *compiled artifact* of each
(arch × shape) cell — FLOPs, HBM bytes and collective bytes measured from
HLO, turned into a bound step time by the same three-term roofline the
perf analysis uses.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class JobProfile:
    key: str                      # "<arch>/<shape>"
    arch: str
    shape: str
    kind: str                     # train | prefill | decode
    chips: int
    step_time_s: float            # dominant roofline term (seconds/step)
    dominant: str
    hbm_bytes_per_chip: float
    flops_per_chip: float
    useful_flops_ratio: float


def profile_from_dryrun(rec: Dict) -> Optional[JobProfile]:
    if not rec.get("ok"):
        return None
    r = rec["roofline"]
    kind = ("train" if rec["shape"].startswith("train")
            else "prefill" if rec["shape"].startswith("prefill") else "decode")
    return JobProfile(
        key=f"{rec['arch']}/{rec['shape']}",
        arch=rec["arch"],
        shape=rec["shape"],
        kind=kind,
        chips=rec["chips"],
        step_time_s=max(r["bound_step_time_s"], 1e-6),
        dominant=r["dominant"],
        hbm_bytes_per_chip=rec["memory"]["per_device_bytes"],
        flops_per_chip=r["model_flops_per_chip"],
        useful_flops_ratio=r["useful_flops_ratio"],
    )


def load_profiles(dryrun_dir: str, mesh: str = "single",
                  rules: str = "best") -> Dict[str, JobProfile]:
    """rules: a specific tag, or "best" = optimized where available,
    baseline otherwise (the fleet runs the §Perf winners)."""
    want = ("optimized", "baseline") if rules == "best" else (rules,)
    out: Dict[str, JobProfile] = {}
    for preferred in reversed(want):          # later overwrites earlier
        for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
            with open(path) as fh:
                rec = json.load(fh)
            if rec.get("mesh") != mesh or rec.get("rules") != preferred:
                continue
            prof = profile_from_dryrun(rec)
            if prof is not None:
                out[prof.key] = prof
    return out


def scaling_curve(prof: JobProfile, chips: int) -> float:
    """Step time when the job runs on a different chip count (elastic
    scaling model): compute/memory terms scale inversely with chips;
    the collective term is assumed flat (ring latency ~ constant payload
    per link for fixed per-chip shards) — a conservative model."""
    base = prof.chips
    return prof.step_time_s * (base / max(chips, 1)) ** 0.9
