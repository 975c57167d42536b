"""Build and load the hand-written CUDA kernels (plain C ABI + ctypes).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with an ``extern "C"`` launcher per kernel,
and loaded with :mod:`ctypes`.  Nothing is compiled when this module is
imported: :func:`library` builds a source at its first use, and
:func:`build_all` starts one ``nvcc`` per source, all at once.

Libraries land in ``build/kernels/`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of source and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  The flags
keep IEEE division and accurate ``expf`` (no ``--use_fast_math``):
Best-Fit scores must be bitwise equal to the host's float32 arithmetic,
and the selective scan and its backward within 1e-4 of their plain
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-prec-div=true", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# launcher name -> argtypes (pointers and the stream as c_void_p)
SIGNATURES: Dict[str, Dict[str, List]] = {
    "alloc_score": {
        # req, avail, capacity, bits, score, J, N, R, device, stream
        "alloc_score_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "ebf_shadow": {
        # avail, req, node_ptr, entry_m, entry_vec, fits, work, M, N, R,
        # nnz, device, stream
        "ebf_shadow_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _P],
        "ebf_shadow_shared_m": [],
    },
    "selective_scan": {
        # u, delta, A, B, C, D, y, h_last, Bt, L, Di, S, dtype code,
        # device, stream
        "selective_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _P],
        # dtype code, aligned, device, int out[5]
        "selective_scan_attributes": [_I, _I, _I, _P],
    },
    "selective_scan_bwd": {
        # u, delta, A, B, C, D, gy, gh, du, ddelta, dA, dB, dC, dD,
        # scratch, scratch floats, Bt, L, Di, S, dtype code, device, stream
        "selective_scan_bwd_launch": [_P] * 15 + [ctypes.c_longlong]
        + [_I] * 6 + [_P],
        # Bt, L, Di, S -> float32 scratch elements of a launch
        "selective_scan_bwd_scratch_floats": [_I, _I, _I, _I],
        # dtype code, aligned, device, int out[6]
        "selective_scan_bwd_attributes": [_I, _I, _I, _P],
    },
    "fleet_engine": {
        # field pointers, field strides, n_fields, scratch, B, M, N, R, K,
        # E, F, S, use_kernel, device, stream
        "fleet_engine_launch": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _P],
        # N, R, device -> 1 if fleet_engine_wide launches that shape
        "fleet_engine_needs_wide": [_I, _I, _I],
        # N, R, device -> dynamic shared memory bytes (0: global tier)
        "fleet_engine_shared_bytes": [_I, _I, _I],
        # M, N, R, device -> int32 scratch elements per sim
        "fleet_engine_scratch_ints": [_I, _I, _I, _I],
    },
}
# the fleet engine's instances past its fast paths: the same launchers,
# from csrc/fleet_engine_wide.cu
SIGNATURES["fleet_engine_wide"] = SIGNATURES["fleet_engine"]
#: launchers that return a 64-bit count (the others return a CUDA error
#: code or an int)
RESTYPES = {"fleet_engine_shared_bytes": ctypes.c_longlong,
            "fleet_engine_scratch_ints": ctypes.c_longlong,
            "selective_scan_bwd_scratch_floats": ctypes.c_longlong}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared device code
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, Tuple[float, str]]:
    """Compile every source (of ``names``, where given) that has no
    up-to-date library, one ``nvcc`` per source, all started together.
    Returns ``{name: (seconds, compiler log)}`` for the sources it
    compiled; raises on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in SIGNATURES if names is None else names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return built


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build_all()
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise unless a launcher's ``cudaGetLastError()`` code is 0."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def check_input(t, name: str, ndim: int, device,
                dtypes=(torch.int32,)) -> None:
    """What every kernel takes: a tensor of one of ``dtypes`` and rank
    ``ndim``, contiguous, on ``device`` (a CPU tensor goes to the plain
    version)."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of "
                        f"{', '.join(map(str, dtypes))}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: rank {t.dim()}, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def device_index(device) -> int:
    """The CUDA ordinal a launcher selects before it launches (the
    libraries link their own CUDA runtime, which does not follow
    PyTorch's current device)."""
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def launch_target(device) -> bool:
    """True when the kernel must launch (a CUDA tensor), False when the
    plain version runs (a CPU tensor); anything else is refused."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {device}")
