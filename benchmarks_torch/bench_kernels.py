"""Dispatch-kernel microbenchmarks (the paper's measured hot spot,
Table 2 / Fig 12-13): per-call latency of the allocation scoring and the
EBF shadow prefix scan — pure-Python loop vs vectorized (the port's
hand-written kernels, ``alloc_score.cu`` and ``ebf_shadow.cu``, on int32
tensors already on ``device``; on the CPU their plain PyTorch versions).

``device`` None means the card (and raises without one).  The kernels
take their own layouts: ``alloc_score`` returns the fit as bits, and
``ebf_shadow`` takes the releases sparse, grouped by node, built from the
dense ``deltas [M, N, R]`` outside the timed window."""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from repro_torch.kernels import alloc_score as k_alloc
from repro_torch.kernels import ebf_shadow as k_ebf
from repro_torch.kernels.ops import resolve_device

from .common import emit

SIZES = (1024, 16384)
R = 4
M = 64


def python_alloc_loop(avail, cap, req):
    n = avail.shape[0]
    fit = np.zeros(n, np.int32)
    score = np.zeros(n, np.float32)
    for i in range(n):
        ok = True
        s = 0.0
        for j in range(avail.shape[1]):
            if avail[i, j] < req[j]:
                ok = False
            c = cap[i, j] if cap[i, j] > 0 else 1
            s += (cap[i, j] - avail[i, j]) / c
        fit[i] = 1 if ok else 0
        score[i] = s
    return fit, score


def _time(fn, *args, reps=20):
    fn(*args)                      # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return 1e6 * (time.perf_counter() - t0) / reps


def draw(rng: np.random.Generator, n_nodes: int):
    """One size's inputs, with the reference's ``rng`` calls in its order:
    (avail, cap [N, R], req [R], deltas [M, N, R]), int32."""
    cap = rng.integers(1, 8, (n_nodes, R)).astype(np.int32)
    avail = rng.integers(0, 8, (n_nodes, R)).clip(0, cap).astype(np.int32)
    req = rng.integers(0, 4, (R,)).astype(np.int32)
    deltas = rng.integers(0, 2, (M, n_nodes, R)).astype(np.int32)
    return avail, cap, req, deltas


def sparse_deltas(deltas: np.ndarray):
    """``deltas [M, N, R]`` as the kernel's releases grouped by node:
    (node_ptr int32[N+1], entry_m int32[nnz], entry_vec int32[nnz, R]),
    one entry per (group, node) with a nonzero vector, group rising
    within a node."""
    node, m = np.nonzero(deltas.any(axis=2).T)
    node_ptr = np.zeros(deltas.shape[1] + 1, np.int32)
    np.cumsum(np.bincount(node, minlength=deltas.shape[1]), out=node_ptr[1:])
    return node_ptr, m.astype(np.int32), deltas[m, node]


def run(out_dir: str = "results/bench", device=None) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    rng = np.random.default_rng(0)
    rows = {}
    for n_nodes in SIZES:
        avail, cap, req, deltas = draw(rng, n_nodes)

        t_py = _time(python_alloc_loop, avail, cap, req, reps=3)
        ta, tc, tr = put(avail), put(cap), put(req)

        def vec_alloc():
            out = k_alloc.alloc_score(ta, tc, tr)
            sync()
            return out
        t_vec = _time(vec_alloc)
        rows[f"alloc_score/n{n_nodes}"] = {
            "python_us": t_py, "vector_us": t_vec,
            "speedup": t_py / t_vec}
        emit(f"kernels/alloc_score_n{n_nodes}", t_vec,
             f"python_us={t_py:.0f};speedup={t_py/t_vec:.0f}x")

        node_ptr, entry_m, entry_vec = (put(x) for x in sparse_deltas(deltas))

        def vec_shadow():
            out = k_ebf.ebf_shadow(ta, node_ptr, entry_m, entry_vec, tr, M)
            sync()
            return out
        t_vec2 = _time(vec_shadow)

        def py_shadow():
            cur = avail.copy()
            fits = np.zeros(M, np.int32)
            for k in range(M):
                cur = cur + deltas[k]
                fits[k] = int(np.all(cur >= req, axis=1).sum())
            return fits
        t_np2 = _time(py_shadow, reps=5)
        rows[f"ebf_shadow/n{n_nodes}"] = {
            "numpy_us": t_np2, "vector_us": t_vec2}
        emit(f"kernels/ebf_shadow_n{n_nodes}", t_vec2,
             f"numpy_us={t_np2:.0f}")
    with open(os.path.join(out_dir, "bench_kernels.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return rows


if __name__ == "__main__":
    print(json.dumps(run(), indent=1))
