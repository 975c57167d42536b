"""Fleet-wide rollout of the §Perf winners (beyond the 3 mandated cells):

* zero3 rules for every train_4k cell (C4's winner),
* the selective-scan kernel's traffic model (``scan_impl="stub"``) for
  ssm/hybrid cells (A1/A5),
* bf16 optimizer state for the >100B archs (B2).

Records land in results/dryrun with rules tag "optimized"; the roofline
report then shows paper-faithful baseline vs optimized side by side.

    PYTHONPATH=src python -m repro_torch.launch.optimize_sweep [--mesh single]
"""
import argparse
import json
import os

from ..configs import ARCH_IDS, applicable_shapes, get_config
from .dryrun import run_cell

BIG = {"llama4-maverick-400b-a17b", "jamba-1.5-large-398b",
       "granite-34b", "internvl2-76b"}


def knobs_for(arch: str, shape: str):
    cfg = get_config(arch)
    scan = "stub" if cfg.family in ("ssm", "hybrid") else "ref"
    if shape.startswith("train"):
        # MoE archs: zero3's weight gathers are dominated by expert
        # weights.  Small experts (fit whole per model shard) -> pure EP;
        # large experts (llama4/jamba class) -> EP + TP-within-expert.
        if cfg.n_experts:
            f = cfg.moe_d_ff or cfg.d_ff
            expert_bytes = 3 * cfg.d_model * f * 2
            n_moe = sum(1 for i in range(cfg.n_layers)
                        if cfg.ffn_kind(i) == "moe")
            local_gib = (cfg.n_experts / 16) * expert_bytes * n_moe / 2**30
            rules = "moe_ep" if local_gib < 4 else "moe_ep2d"
        else:
            rules = "zero3"
        return dict(rules=rules, microbatches=1, scan_impl=scan,
                    state_dtype="bfloat16" if arch in BIG else "float32")
    # inference cells: keep baseline sharding; fix the scan traffic
    if scan == "stub":
        return dict(rules="baseline", scan_impl="stub")
    return None                      # baseline already optimal-ish


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            kn = knobs_for(arch, shape)
            if kn is None:
                continue
            tag = "optimized"
            path = os.path.join(
                args.out, f"{arch}__{shape}__{args.mesh}__{tag}.json")
            if args.skip_existing and os.path.exists(path):
                continue
            rules = kn.pop("rules")
            if args.mesh == "multi" and rules in ("zero3", "moe_ep",
                                                  "moe_ep2d"):
                rules += "_multi"     # sequence splits across pods
            rec = run_cell(arch, shape, args.mesh, rules, tag=tag, **kn)
            with open(path, "w") as fh:
                json.dump(rec, fh, indent=1)
            if rec["ok"]:
                r = rec["roofline"]
                print(f"[ok] {arch} {shape}: bound={r['bound_step_time_s']:.3f}s "
                      f"dom={r['dominant']} mem={rec['memory']['per_device_gib']}GiB "
                      f"fits={rec['memory']['fits_16gib_hbm']}")
            else:
                print(f"[FAIL] {arch} {shape}: {rec['error'][:120]}")


if __name__ == "__main__":
    main()
