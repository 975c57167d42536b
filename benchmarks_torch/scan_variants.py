#!/usr/bin/env python3
"""Time design variants of the ``selective_scan`` CUDA kernel on one GPU.

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``::

    python3 benchmarks_torch/scan_variants.py [--earlier PATH_TO_OLD.cu]

Each variant is the kernel source of ``src/repro_torch/kernels/csrc/
selective_scan.cu`` with some of its tile constants replaced (states per
thread, steps per staged chunk, resident blocks wanted), built by
``nvcc`` with the port's flags into ``build/scan_variants/`` and timed
at the falcon-mamba-7b serve shape (Bt 4 x L 1000 x Di 8192 x S 16) on
bf16 and float32 inputs, each held within 1e-4 of the plain version.
``no_aligned``, ``no_full`` and ``general`` turn off the kernel's
16-byte-aligned path, its path without bound checks, or both, so that
each specialization's gain is measured.  ``--earlier`` also times an
earlier design's source (one float32 entry point without the dtype code,
as before the native-type read), on float32 copies of the same values.
The variants run in turns (``--turns``, 2 by default).  Prints one JSON
line per timing and, last, the medians by variant.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from chip_smoke import time_ms  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

OUT = os.path.join(ROOT, "build", "scan_variants")
SHAPE = (4, 1000, 8192, 16)
_PER8 = ("constexpr int kPer = 4; ", "constexpr int kPer = 8; ")
_CHUNK64 = ("constexpr int kChunk = 32;", "constexpr int kChunk = 64;")
# a 64-step chunk needs more than 48 KB of shared memory in float32
_NO_LIMIT = ("static_assert(smem_bytes<float>() <= 48 * 1024",
             "static_assert(true")
_OPT_IN = ("  if (aligned) {\n    selective_scan_kernel<E, true>",
           "  cudaFuncSetAttribute(selective_scan_kernel<E, true>, "
           "cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);\n"
           "  cudaFuncSetAttribute(selective_scan_kernel<E, false>, "
           "cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);\n"
           "  if (aligned) {\n    selective_scan_kernel<E, true>")
_NO_ALIGNED = ("const bool aligned =\n", "const bool aligned = false &&\n")
_NO_FULL = ("if (n == kChunk && S == kMaxS) {", "if (false) {")
VARIANTS = {
    "as_built": [],
    "no_aligned": [_NO_ALIGNED],
    "no_full": [_NO_FULL],
    "general": [_NO_ALIGNED, _NO_FULL],
    "states8": [_PER8],
    "states8_chunk64": [_PER8, _CHUNK64, _NO_LIMIT, _OPT_IN],
    "chunk64": [_CHUNK64, _NO_LIMIT, _OPT_IN],
    "states16_tile128": [
        ("constexpr int kPer = 4; ", "constexpr int kPer = 16; "),
        ("constexpr int kTileD = 64;", "constexpr int kTileD = 128;"),
        ("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 2;"),
        _CHUNK64, _NO_LIMIT, _OPT_IN],
}


def build_variants(earlier):
    """Write and compile every variant (and ``earlier``), all at once;
    returns ``{name: (library path, ptxas register lines)}``."""
    os.makedirs(OUT, exist_ok=True)
    with open(build.CSRC / "selective_scan.cu") as f:
        src = f.read()
    sources = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
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
                      sorted({ln.split(" : ")[-1].strip()
                              for ln in log.splitlines()
                              if "registers" in ln or "spill" in ln}))
    return libs



def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--earlier", help="an earlier design's .cu source")
    parser.add_argument("--turns", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_variants(args.earlier)

    bt, length, di, s = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.randn(bt, length, di, device=dev, generator=gen)
    dt = torch.rand(bt, length, di, device=dev, generator=gen) * 0.1
    A = -torch.rand(di, s, device=dev, generator=gen) - 0.1
    B = torch.randn(bt, length, s, device=dev, generator=gen)
    C = torch.randn(bt, length, s, device=dev, generator=gen)
    D = torch.randn(di, device=dev, generator=gen)
    narrow = [x.to(torch.bfloat16) for x in (u, dt, B, C)]
    wide = [x.float() for x in narrow]
    want = ref.selective_scan_ref(narrow[0], narrow[1], A, narrow[2],
                                  narrow[3], D)
    y = torch.empty(bt, length, di, device=dev)
    h = torch.empty(bt, di, s, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    argtypes = build.SIGNATURES["selective_scan"]["selective_scan_launch"]

    def launcher(name, inputs, code):
        lib = ctypes.CDLL(libs[name][0])
        fn = lib.selective_scan_launch
        ptrs = [t.data_ptr() for t in (inputs[0], inputs[1], A, inputs[2],
                                       inputs[3], D, y, h)]
        if name == "earlier":   # the earlier launcher: no dtype code
            fn.argtypes = argtypes[:12] + argtypes[13:]
            return lambda: fn(*ptrs, bt, length, di, s, 0, stream)
        fn.argtypes = argtypes
        return lambda: fn(*ptrs, bt, length, di, s, code, 0, stream)

    runs = []
    for name in libs:
        types = {"float32": (wide, 0)}
        if name != "earlier":
            types["bfloat16"] = (narrow, 1)
        for tname, (inputs, code) in types.items():
            runs.append((name, tname, launcher(name, inputs, code)))
    medians = {}
    for turn in range(args.turns):
        for name, tname, call in runs:
            y.zero_()
            build.check(call(), name)
            torch.cuda.synchronize()
            err = max(float((y - want[0]).abs().max()),
                      float((h - want[1]).abs().max()))
            if not (torch.allclose(y, want[0], rtol=1e-4, atol=1e-4) and
                    torch.allclose(h, want[1], rtol=1e-4, atol=1e-4)):
                raise AssertionError(f"{name}/{tname}: not within 1e-4 of "
                                     f"the plain version ({err})")
            ms = time_ms(call)
            medians.setdefault(f"{name}/{tname}", []).append(ms)
            print(json.dumps({"variant": name, "dtype": tname, "turn": turn,
                              "ms": ms, "max_abs_err": err,
                              "ptxas": libs[name][1]}), flush=True)
    print(smi)
    print(json.dumps({k: statistics.median(v) for k, v in medians.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
