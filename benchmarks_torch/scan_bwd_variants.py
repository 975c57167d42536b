#!/usr/bin/env python3
"""Time design variants of the ``selective_scan_bwd`` CUDA kernel on one GPU.

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``::

    python3 benchmarks_torch/scan_bwd_variants.py [--earlier OLD.cu]
        [--variants as_built,no_full,...] [--turns 2]

Each variant is the kernel source of ``src/repro_torch/kernels/csrc/
selective_scan_bwd.cu`` with some of its constants or paths replaced,
built by ``nvcc`` with the port's flags into ``build/scan_bwd_variants/``;
``--earlier`` adds an earlier design's source with the same C interface
(``selective_scan_bwd_launch``, ``selective_scan_bwd_scratch_floats``),
such as the parent commit's file.  Every source is timed (CUDA events,
the median of 7 rounds of 20 back-to-back calls) at the falcon-mamba-7b
training shape (Bt 2 x L 512 x Di 8192 x S 16, bf16) and at the Jamba
smoke config's training shape (Bt 1 x L 64 x Di 128 x S 8, float32),
each result held within the smoke's ``GRAD_TOL`` of the plain backward
(``ref.selective_scan_bwd_ref``).  The sources run in turns (``--turns``)
so that a drift of the card's clocks spreads over all of them.  Prints
the card's name and power limit, one JSON line per timing, ptxas's
registers, shared memory and spills of each source, and last the medians
by source and shape.  ``ABLATIONS`` leave parts of the kernel out (not
checked: they do not compute the backward) to show what each part
costs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from chip_smoke import GRAD_TOL, bwd_case, time_ms  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.selective_scan import DTYPE_CODES  # noqa: E402

OUT = os.path.join(ROOT, "build", "scan_bwd_variants")
SHAPES = {"train": ((2, 512, 8192, 16), torch.bfloat16),
          "jamba_train": ((1, 64, 128, 8), torch.float32)}
# edits of the source: (old text, new text)
VARIANTS = {
    "as_built": [],
    # every walk chunk through the checked path (steps not unrolled bare)
    "no_full": [("if (sp.n == kChunk) {", "if (false) {")],
    # the offset arithmetic of unaligned rows on every input
    "no_aligned": [("const bool aligned = (ptrs & 15) == 0 &&",
                    "const bool aligned = false && (ptrs & 15) == 0 &&")],
    # no residency asked of ptxas: registers uncapped
    "min_blocks1": [("constexpr int kMinBlocks = 2;",
                     "constexpr int kMinBlocks = 1;")],
    # pass 1 in 16-step stages
    "pass1_16": [("constexpr int kChunk1 = 32;",
                  "constexpr int kChunk1 = 16;")],
    # three chunks staged at once (float32 then fits one block an SM)
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
                ("static_assert(kMinBlocks * (Smem<float>::kBytes",
                 "static_assert(1 || kMinBlocks * (Smem<float>::kBytes")],
}
# ablations: parts of the kernel left out, to see what each costs; they
# do not compute the backward, so their results are not checked
ABLATIONS = {
    # pass 1 alone (its chunks' staging, widening and checkpoints)
    "only_pass1": [("  for (int j = 0; j < chunks; ++j) {",
                    "  for (int j = 0; j < 0; ++j) {")],
    # pass 1 and the recompute, no walk back
    "no_walk": [("      walk_chunk<E, true>(",
                 "      if (0) walk_chunk<E, true>("),
                ("      walk_chunk<E, false>(",
                 "      if (0) walk_chunk<E, false>(")],
    # no writing out of each chunk's dB, dC, du and ddelta
    "no_flush": [("    if (j > 0) flush(span_of(j - 1));\n", "")],
    # what the accurate exponentials cost: __expf (one MUFU.EX2 and a
    # multiply), or none at all (1 + x)
    "fast_exp": [("expf(", "__expf(")],
    "no_exp": [("expf(", "(1.0f + ")],
    # no barrier between a chunk's widening and its use
    "no_sync2": [("    __syncthreads();\n    if (sp.n == kChunk) {",
                  "    if (sp.n == kChunk) {")],
}
VARIANTS.update(ABLATIONS)


def build_variants(names, earlier):
    """Write and compile the variants (and ``earlier``), all at once;
    returns ``{name: (library path, ptxas lines)}``."""
    os.makedirs(OUT, exist_ok=True)
    with open(build.CSRC / "selective_scan_bwd.cu") as f:
        src = f.read()
    sources = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            text = text.replace(old, new)
        sources[name] = os.path.join(OUT, f"{name}.cu")
        with open(sources[name], "w") as f:
            f.write(text)
    if earlier:
        sources["earlier"] = earlier
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o",
         os.path.join(OUT, f"lib{name}.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = (os.path.join(OUT, f"lib{name}.so"),
                      [ln.split("ptxas info    : ")[-1].strip()
                       for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln
                       or "Compiling entry" in ln])
    return libs


def launcher(path, dev, shape, dtype):
    """(call, inputs, outputs) of one library's launcher on fresh inputs
    at ``shape``: ``call()`` launches once and returns the error code."""
    lib = ctypes.CDLL(path)
    sig = build.SIGNATURES["selective_scan_bwd"]
    for fn in ("selective_scan_bwd_launch",
               "selective_scan_bwd_scratch_floats"):
        getattr(lib, fn).argtypes = sig[fn]
    lib.selective_scan_bwd_scratch_floats.restype = ctypes.c_longlong
    bt, length, di, s = shape
    args = bwd_case(np.random.default_rng(6), dev, bt, length, di, s, dtype)
    u, delta, A, B, C, D, gy, gh = args
    outs = (torch.empty_like(u), torch.empty_like(delta),
            torch.empty((di, s), device=dev), torch.empty_like(B),
            torch.empty_like(C), torch.empty((di,), device=dev))
    n = lib.selective_scan_bwd_scratch_floats(bt, length, di, s)
    scratch = torch.empty((n,), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*args, *outs, scratch)]

    def call(_alive=(args, outs, scratch)):   # the pointers' tensors
        return lib.selective_scan_bwd_launch(
            *ptrs, n, bt, length, di, s, DTYPE_CODES[dtype], dev.index or 0,
            stream)
    return call, args, outs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--earlier", help="an earlier design's .cu source")
    parser.add_argument("--variants", default=",".join(
        v for v in VARIANTS if v not in ABLATIONS))
    parser.add_argument("--turns", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("scan_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_variants([v for v in args.variants.split(",") if v],
                          args.earlier)
    for name, (_, ptxas) in libs.items():
        print(json.dumps({"source": name, "ptxas": ptxas}), flush=True)
    runs = []
    for shape_name, (shape, dtype) in SHAPES.items():
        want = None
        for name, (path, _) in libs.items():
            call, inputs, outs = launcher(path, dev, shape, dtype)
            if want is None:          # kept on the host, out of the way
                want = [w.cpu() for w in ref.selective_scan_bwd_ref(*inputs)]
            runs.append((name, shape_name, call, outs, want))
    medians = {}
    for turn in range(args.turns):
        for name, shape_name, call, outs, want in runs:
            for o in outs:
                o.fill_(float("nan"))
            build.check(call(), name)
            torch.cuda.synchronize()
            rel = 0.0
            for i, (g, w) in enumerate(zip(outs, want)):
                if name in ABLATIONS:
                    rel = None
                    break
                g = g.cpu()
                scale = max(float(w.abs().max()), 1e-30)
                e = float((g.double() - w.double()).abs().max())
                if not e <= GRAD_TOL[g.dtype] * scale:
                    raise AssertionError(
                        f"{name}/{shape_name}: gradient {i} off by {e} of "
                        f"{scale} ({int(g.isnan().sum())} NaN, plain "
                        f"{int(w.isnan().sum())} NaN)")
                rel = max(rel, e / scale)
            ms = time_ms(lambda: build.check(call(), name))
            medians.setdefault(f"{name}/{shape_name}", []).append(ms)
            print(json.dumps({"source": name, "shape": shape_name,
                              "turn": turn, "ms": ms,
                              "max_err_of_largest": rel}), flush=True)
    print(smi)
    print(json.dumps({k: statistics.median(v) for k, v in medians.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
