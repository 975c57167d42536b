"""§Roofline report generator: renders the per-(arch × shape × mesh)
three-term roofline table from the dry-run records, computes the
roofline fraction (useful compute time / bound step time) and emits
markdown consumed by EXPERIMENTS.md.

The records are the port's dry-run's (``repro_torch.launch.dryrun``),
and the peak rates are the H100 constants of ``repro_torch.launch.mesh``;
nothing here runs on a device."""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

from repro_torch.launch.mesh import PEAK_FLOPS_BF16

from .common import emit


def load(dryrun_dir: str = "results/dryrun", rules: str = None) -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(p) as fh:
            r = json.load(fh)
        if rules and r.get("rules") != rules:
            continue
        recs.append(r)
    return recs


def roofline_fraction(rec: Dict) -> float:
    """Useful-model-compute time over the bound step time — the fraction
    of the dominant-term roofline actually doing model FLOPs (an MFU
    upper bound for the cell)."""
    r = rec["roofline"]
    useful_s = r["model_flops_per_chip"] / PEAK_FLOPS_BF16
    return useful_s / max(r["bound_step_time_s"], 1e-12)


_IDEAL_CACHE: Dict = {}


def ideal_bytes_per_dev(rec: Dict) -> float:
    """Minimum achievable HBM traffic per device for the cell: every
    parameter shard + (for decode) cache shard read once, plus token I/O.
    This is the MBU denominator for bandwidth-bound cells."""
    key = (rec["arch"], rec["shape"], rec["mesh"], rec["rules"])
    if key in _IDEAL_CACHE:
        return _IDEAL_CACHE[key]
    import numpy as np
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import RULE_SETS, logical_to_spec, map_axes

    cfg = get_config(rec["arch"])
    model = build_model(cfg, "meta")
    shape = SHAPES[rec["shape"]]
    mesh_shape = ((2, 16, 16) if rec["mesh"] == "multi" else (16, 16))
    mesh_names = (("pod", "data", "model") if rec["mesh"] == "multi"
                  else ("data", "model"))

    class _M:                       # lightweight mesh stand-in
        axis_names = mesh_names
        devices = np.zeros(mesh_shape)

    sizes = dict(zip(mesh_names, mesh_shape))
    rules_name = rec.get("rules_base") or rec["rules"].split("+")[0]
    rules = RULE_SETS.get(rules_name, RULE_SETS["baseline"])

    def per_dev(shapes_tree, axes_tree):
        parts = []

        def leaf(a, s):
            spec = logical_to_spec(a, _M, rules, dims=tuple(s.shape))
            shard = 1
            for part in spec:
                for ax in ((part,) if isinstance(part, str) else (part or ())):
                    shard *= sizes.get(ax, 1)
            parts.append((np.prod(s.shape) * s.dtype.itemsize) / shard)
        map_axes(leaf, axes_tree, shapes_tree)
        return float(sum(parts))

    total = per_dev(model.param_shapes(), model.param_logical_axes())
    if shape.kind == "decode":
        cs = model.cache_shapes(shape.global_batch, shape.seq_len)
        total += 2 * per_dev(cs, model.cache_logical_axes())  # read + write
    elif shape.kind in ("train",):
        total *= 4.0     # fwd read + grads write + optimizer read/write
    _IDEAL_CACHE[key] = total
    return total


def bandwidth_fraction(rec: Dict) -> float:
    """MBU-style fraction: ideal minimum HBM time / bound step time."""
    from repro_torch.launch.mesh import HBM_BW
    ideal_s = ideal_bytes_per_dev(rec) / HBM_BW
    return ideal_s / max(rec["roofline"]["bound_step_time_s"], 1e-12)


def cell_score(rec: Dict) -> float:
    """The per-cell roofline score: MFU for compute-leaning cells, MBU
    for bandwidth-bound ones — max of the two fractions."""
    return max(roofline_fraction(rec), bandwidth_fraction(rec))


def render_markdown(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | rules | GiB/dev | fits | compute_s | "
        "memory_s | collective_s | dominant | useful | MFU_frac | MBU_frac | score |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"{r.get('rules','?')} | — | — | FAILED: "
                         f"{r.get('error','')[:60]} |")
            continue
        ro, me = r["roofline"], r["memory"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['rules']} "
            f"| {me['per_device_gib']:.2f} | {'Y' if me['fits_16gib_hbm'] else 'N'} "
            f"| {ro['compute_s']:.4g} | {ro['memory_s']:.4g} "
            f"| {ro['collective_s']:.4g} | {ro['dominant']} "
            f"| {ro['useful_flops_ratio']:.2f} | {roofline_fraction(r):.4f} "
            f"| {bandwidth_fraction(r):.4f} | {cell_score(r):.4f} |")
    return "\n".join(lines)


def run(out_dir: str = "results/bench",
        dryrun_dir: str = "results/dryrun") -> dict:
    os.makedirs(out_dir, exist_ok=True)
    recs = load(dryrun_dir)
    ok = [r for r in recs if r.get("ok")]
    md = render_markdown(recs)
    with open(os.path.join(out_dir, "roofline.md"), "w") as fh:
        fh.write(md + "\n")
    stats = {
        "cells": len(recs), "ok": len(ok),
        "dominant_compute": sum(1 for r in ok
                                if r["roofline"]["dominant"] == "compute"),
        "dominant_memory": sum(1 for r in ok
                               if r["roofline"]["dominant"] == "memory"),
        "dominant_collective": sum(
            1 for r in ok if r["roofline"]["dominant"] == "collective"),
        "fits": sum(1 for r in ok if r["memory"]["fits_16gib_hbm"]),
    }
    if ok:
        best = max(ok, key=cell_score)
        worst = min((r for r in ok if r["shape"].startswith("train")),
                    key=cell_score, default=best)
        stats["best_cell"] = (f"{best['arch']}/{best['shape']}/{best['mesh']}"
                              f"={cell_score(best):.3f}")
        stats["worst_train_cell"] = (
            f"{worst['arch']}/{worst['shape']}/{worst['mesh']}"
            f"={cell_score(worst):.4f}")
        for r in ok:
            emit(f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}/{r['rules']}",
                 r["roofline"]["bound_step_time_s"] * 1e6,
                 f"dom={r['roofline']['dominant']};"
                 f"score={cell_score(r):.4f}")
    with open(os.path.join(out_dir, "roofline_stats.json"), "w") as fh:
        json.dump(stats, fh, indent=1)
    return stats


if __name__ == "__main__":
    print(json.dumps(run(), indent=1))
