"""§Perf hillclimb: hypothesis -> change -> re-trace -> record.

Three cells (selection criteria per the assignment):
  A. falcon-mamba-7b / train_4k / single   — worst roofline fraction
  B. llama4-maverick-400b-a17b / train_4k / single — most collective-bound
  C. qwen3-1.7b / train_4k / single        — canonical dense training job
     (the representative workload the AccaSim cluster layer schedules)

Each iteration is a named knob set; records land in results/dryrun with
the iteration tag in the ``rules`` field and the full narrative appends
to results/perf_log.json.  The cells, tags and knobs are the
reference's; each hypothesis is restated for the H100 constants of
``launch/mesh.py``, without the reference's TPU figures.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell A,B,C]
"""
import argparse
import json
import os
import time
from typing import Dict, List

from .dryrun import run_cell

ITERATIONS: List[Dict] = [
    # ---------------- Cell A: falcon-mamba-7b train_4k --------------
    dict(cell="A", arch="falcon-mamba-7b", shape="train_4k",
         tag="A1-scan-kernel",
         knobs=dict(scan_impl="stub"),
         hypothesis=(
             "The baseline memory term is dominated by the plain "
             "selective scan: each of the L=4096 steps of its loop "
             "round-trips the [B,Di,S] state through HBM, in every one "
             "of the 64 layers. The scan kernel keeps the state on chip "
             "across the sequence, so HBM traffic collapses to the "
             "streamed u/dt/B/C/y blocks: the memory term should drop "
             "by two orders of magnitude or more.")),
    dict(cell="A", arch="falcon-mamba-7b", shape="train_4k",
         tag="A2-scan-kernel+dots",
         knobs=dict(scan_impl="stub", remat="dots"),
         hypothesis=(
             "With scan traffic fixed, full remat recomputes every "
             "elementwise chain in backward (~1.5x forward bytes). "
             "Saving matmul outputs (dots policy) trades some HBM per "
             "device for skipping recompute -> memory term -20-30%.")),
    dict(cell="A", arch="falcon-mamba-7b", shape="train_4k",
         tag="A3-scan-kernel+dots+mb8",
         knobs=dict(scan_impl="stub", remat="dots", microbatches=8),
         hypothesis=(
             "Doubling microbatches (4->8) halves the live activation "
             "footprint per pass; bytes stay ~flat; expect a "
             "neutral-to-small memory-term change and a smaller "
             "per-device footprint.")),

    dict(cell="A", arch="falcon-mamba-7b", shape="train_4k",
         tag="A4-scan-kernel+mb16",
         knobs=dict(scan_impl="stub", microbatches=16),
         hypothesis=(
             "If A2 refutes the dots policy (saving dot outputs adds "
             "writes, and recompute is counted either way), revert to "
             "full remat. mb16 should quarter A1's live activations "
             "again with flat terms.")),
    dict(cell="A", arch="falcon-mamba-7b", shape="train_4k",
         tag="A5-scan-kernel+zero3",
         knobs=dict(scan_impl="stub", rules="zero3", microbatches=1),
         hypothesis=(
             "A1's residual collective term is TP all-reduce on "
             "[tokens/dev-row, 4096] activations around in/out_proj "
             "(d_inner sharded over model). zero3 runs each sample "
             "fully local (batch over all 256 devices) and ZeRO-gathers "
             "the 7B params (~3 x 14GB/256 per device-pass): expect the "
             "collective term down by several times AND the memory term "
             "down ~10x (elementwise no longer replicated 16x).")),

    # ---------------- Cell B: llama4-maverick train_4k --------------
    dict(cell="B", arch="llama4-maverick-400b-a17b", shape="train_4k",
         tag="B1-ep-fsdp",
         knobs=dict(rules="ep_fsdp"),
         hypothesis=(
             "The baseline collective term is per-layer activation "
             "all-reduce from tensor parallelism: ~65k tokens/dev-row x "
             "5120 x 4B x 1.875 x 2/layer x 48 x 3 passes ~ 1.4TB/dev. "
             "ep_fsdp removes TP on activations (sequence-sharded "
             "instead), keeps expert parallelism over 'model', and "
             "ZeRO-gathers dense weights (~3 x dense-param bytes). "
             "Expect all-gathers of weights, the MoE all-to-all and the "
             "grad reduce-scatter to replace it: a >10x smaller "
             "collective term.")),
    dict(cell="B", arch="llama4-maverick-400b-a17b", shape="train_4k",
         tag="B2-ep-fsdp+bf16opt",
         knobs=dict(rules="ep_fsdp", state_dtype="bfloat16"),
         hypothesis=(
             "400B params x (8B fp32 m+v)/256 devices = 12.5 GB/dev of "
             "optimizer state alone. bf16 m/v halves it; the per-device "
             "footprint should drop by ~6 GB with unchanged step-time "
             "terms (optimizer reads shrink slightly).")),
    dict(cell="B", arch="llama4-maverick-400b-a17b", shape="train_4k",
         tag="B3-ep-fsdp+bf16opt+mb8",
         knobs=dict(rules="ep_fsdp", state_dtype="bfloat16",
                    microbatches=8),
         hypothesis=(
             "Remaining temp pressure is per-microbatch activations+"
             "logits ([mb-tokens/dev, 12.6k vocab shard] f32). mb 4->8 "
             "halves it; collective/compute terms unchanged.")),

    dict(cell="B", arch="llama4-maverick-400b-a17b", shape="train_4k",
         tag="B4-zero3-dense+ep",
         knobs=dict(rules="zero3", state_dtype="bfloat16", microbatches=1),
         hypothesis=(
             "If ep_fsdp still pays activation reshards at attention "
             "(heads unsharded but seq sharded), full zero3 (batch over "
             "all 256, experts EP over model, weights gathered) trades "
             "them for weight all-gathers: 400B x 2B / 256 = 3.1GB/dev "
             "per pass x3 = 9.4GB... but the expert weights' all-gather "
             "is the risk: only 8/128 experts per device are LOCAL; with "
             "tokens resident per device the dispatch all-to-all "
             "replaces it. Measure which the placement picks.")),

    # ---------------- Cell C: qwen3-1.7b train_4k -------------------
    dict(cell="C", arch="qwen3-1.7b", shape="train_4k",
         tag="C1-seqparallel",
         knobs=dict(rules="seqparallel"),
         hypothesis=(
             "The baseline memory term is far above the compute term: "
             "unfused traffic on full-size activations ([16,4096,2048] "
             "per dev) for every norm/rope/softmax chain, replicated 16x "
             "across the model axis. Sequence parallelism shards these "
             "over 'model' -> elementwise bytes /16; all-reduce becomes "
             "reduce-scatter+all-gather (same link bytes). Expect the "
             "memory term -5..10x, collective ~flat.")),
    dict(cell="C", arch="qwen3-1.7b", shape="train_4k",
         tag="C2-seqparallel+dots",
         knobs=dict(rules="seqparallel", remat="dots"),
         hypothesis=(
             "Full remat re-runs every forward op in backward; saving "
             "dot outputs cuts the recompute pass: expect the memory "
             "term -25% at a larger per-device footprint.")),
    dict(cell="C", arch="qwen3-1.7b", shape="train_4k",
         tag="C3-seqparallel+dots+mb1",
         knobs=dict(rules="seqparallel", remat="dots", microbatches=1),
         hypothesis=(
             "Grad accumulation re-reads all weights+opt state per "
             "microbatch; at 1.7B params FSDP-sharded that is small "
             "(~27MB/dev x 4), but the accumulation buffer adds f32 "
             "param-sized read+write per microbatch. mb=1 removes both: "
             "expect a small (~5%) memory-term win, larger temp.")),
    dict(cell="C", arch="qwen3-1.7b", shape="train_4k",
         tag="C4-zero3",
         knobs=dict(rules="zero3", microbatches=1),
         hypothesis=(
             "If C1/C2 refute seq-parallelism here (RS+AG pairs plus "
             "head-axis reshards raising the collective term above the "
             "baseline's memory term), the root cause is that ANY "
             "model-axis sharding of activations pays per-layer "
             "collectives ~ tokens x d. zero3 removes model-axis "
             "activation sharding entirely: batch over all 256 devices "
             "(1 sample/dev), weights ZeRO-gathered (~3 x 3.4GB/256 = "
             "40MB/dev-pass) + grad reduce-scatter. Expect the "
             "collective term to become small, memory /8 (elementwise "
             "not replicated), and the bound to move toward compute.")),
    dict(cell="A", arch="falcon-mamba-7b", shape="train_4k",
         tag="A6-scan-kernel+zero3+noremat",
         knobs=dict(scan_impl="stub", rules="zero3", microbatches=1,
                    remat="none"),
         hypothesis=(
             "If A5 confirms zero3, the remaining memory term includes "
             "the full-remat recompute pass (~1/3 of forward traffic). "
             "Without remat, activations are saved instead of "
             "recomputed: expect memory -20-30% if the saved "
             "activations (64L x 4096 tok x 8192 d_inner x ...) still "
             "fit; risk: the temporaries outgrow the device's HBM.")),
    dict(cell="B", arch="llama4-maverick-400b-a17b", shape="train_4k",
         tag="B5-moe-ep2d",
         knobs=dict(rules="moe_ep2d", state_dtype="bfloat16",
                    microbatches=1),
         hypothesis=(
             "If B1-B3 refute ep_fsdp (the collective term stuck: with "
             "'mlp' on model and unsharded activations the placement "
             "still picks TP partial-matmuls) and B4 (zero3) gathers "
             "FULL 2D-sharded expert weights per pass (~params/16 per "
             "device), moe_ep2d shards expert f over 'data' and pays the "
             "per-expert partial-sum all-reduce on [8, C, 5120] "
             "activations instead: napkin ~1.6GB/MoE-layer-pass x24 x3 "
             "= 115GB of collectives; expert weights never materialize, "
             "so the temporaries drop by ~25GB. Expect the bound to be "
             "memory-dominant.")),
    dict(cell="C", arch="qwen3-1.7b", shape="train_4k",
         tag="C5-zero3+mb2",
         knobs=dict(rules="zero3", microbatches=2),
         hypothesis=(
             "If C4 fits poorly (logits [4096 tok, 9.5k vocab-shard] "
             "f32 + no-remat backward of a full sample per device), "
             "microbatching at the sample level is impossible (1 "
             "sample/dev) — mb=2 splits the 4096-token sequence batch "
             "dim only if batch/dev >= 2; expect FAIL or no-op: "
             "documents the zero3/grad-accum interaction.")),
    dict(cell="C", arch="qwen3-1.7b", shape="train_4k",
         tag="C6-zero3+noremat",
         knobs=dict(rules="zero3", microbatches=1, remat="none"),
         hypothesis=(
             "If C4 confirms zero3 and C5 refutes microbatching under "
             "zero3 (1 sample/dev cannot split), the remaining memory "
             "term is forward + full recompute + backward traffic. "
             "remat=none removes the recompute pass: expect memory "
             "-25-30%; the saved activations (~28L x 4096 x 2048 x "
             "f32-ish) add a few GB per device.")),
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="A,B,C")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--log", default="results/perf_log.json")
    ap.add_argument("--only-tag", default=None)
    args = ap.parse_args()
    cells = set(args.cell.split(","))

    log = []
    if os.path.exists(args.log):
        with open(args.log) as fh:
            log = json.load(fh)
    done_tags = {e["tag"] for e in log}

    for it in ITERATIONS:
        if it["cell"] not in cells:
            continue
        if args.only_tag and it["tag"] != args.only_tag:
            continue
        if it["tag"] in done_tags:
            print(f"[skip] {it['tag']} already logged")
            continue
        knobs = dict(it["knobs"])
        rules = knobs.pop("rules", "baseline")
        t0 = time.time()
        rec = run_cell(it["arch"], it["shape"], args.mesh, rules,
                       tag=it["tag"], **knobs)
        path = os.path.join(
            args.out, f"{it['arch']}__{it['shape']}__{args.mesh}__{it['tag']}.json")
        with open(path, "w") as fh:
            json.dump(rec, fh, indent=1)
        entry = {
            "tag": it["tag"], "cell": it["cell"], "arch": it["arch"],
            "shape": it["shape"], "hypothesis": it["hypothesis"],
            "knobs": it["knobs"], "ok": rec["ok"],
            "wall_s": round(time.time() - t0, 1),
        }
        if rec["ok"]:
            entry["roofline"] = rec["roofline"]
            entry["memory_gib"] = rec["memory"]["per_device_gib"]
            entry["fits"] = rec["memory"]["fits_16gib_hbm"]
            r = rec["roofline"]
            print(f"[{it['tag']}] compute={r['compute_s']:.3f}s "
                  f"memory={r['memory_s']:.3f}s "
                  f"collective={r['collective_s']:.3f}s "
                  f"dominant={r['dominant']} "
                  f"mem/dev={rec['memory']['per_device_gib']}GiB "
                  f"fits={entry['fits']}")
        else:
            entry["error"] = rec["error"]
            print(f"[{it['tag']}] FAILED: {rec['error']}")
        log.append(entry)
        with open(args.log, "w") as fh:
            json.dump(log, fh, indent=1)


if __name__ == "__main__":
    main()
