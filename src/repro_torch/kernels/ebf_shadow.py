"""EASY-backfilling shadow-time computation (CUDA kernel + host driver).

The paper's measured hot spot (Table 2: EBF spends 21:41 of 22:24 total in
dispatching) is the shadow-time computation: walk release events of
running jobs in estimated-release order, accumulate freed resources, and
find the first prefix at which the blocked head job fits.

* :func:`ebf_shadow` — the kernel wrapper.  Release events grouped by
  distinct release time form a dense delta tensor ``deltas[M, N, R]``;
  the kernel (``csrc/ebf_shadow.cu``) counts, per release prefix, the
  nodes whose cumulative availability fits the head's request.
* :func:`shadow_from_releases` — the host-path driver on top of it:
  groups the ``(time, nodes, vec)`` release tuples, launches the
  fit-count scan (``ops.ebf_shadow_fits``), and returns ``(shadow_time,
  shadow_avail)`` — what ``VectorizedEasyBackfilling`` calls per blocked
  head.

Semantics are the tie-grouped prefix scan: every release sharing a
timestamp is applied before the fit test.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build, counters, ref

#: largest resource-type count the kernel keeps in registers
MAX_R = 8


def ebf_shadow(avail: torch.Tensor, deltas: torch.Tensor,
               req: torch.Tensor) -> torch.Tensor:
    """fits int32[M]: fitting-node count per release prefix.

    ``avail int32[N, R]``, ``deltas int32[M, N, R]``, ``req int32[R]``.
    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version.
    """
    dev = avail.device
    build.check_input(avail, "avail", 2, dev)
    build.check_input(deltas, "deltas", 3, dev)
    build.check_input(req, "req", 1, dev)
    m, n, r = deltas.shape
    if (n, r) != tuple(avail.shape) or req.shape[0] != r or r < 1:
        raise ValueError(f"shapes avail {tuple(avail.shape)}, deltas "
                         f"{tuple(deltas.shape)}, req {tuple(req.shape)}")
    if not build.launch_target(dev):
        return ref.ebf_shadow_ref(avail, deltas, req)
    if r > MAX_R:
        raise ValueError(f"ebf_shadow kernel takes R <= {MAX_R}, got {r}")
    if n == 0:                     # no node fits any prefix
        return torch.zeros((m,), dtype=torch.int32, device=dev)
    fits = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return fits
    lib = build.library("ebf_shadow")
    index = build.device_index(dev)
    stream = torch.cuda.current_stream(index).cuda_stream
    build.check(lib.ebf_shadow_launch(
        avail.data_ptr(), deltas.data_ptr(), req.data_ptr(),
        fits.data_ptr(), m, n, r, index, stream), "ebf_shadow")
    counters.record_device("ebf_shadow")
    return fits


# ----------------------------------------------------------------------
# host path: release tuples -> (shadow_time, shadow_avail)
# ----------------------------------------------------------------------
def group_releases(avail: np.ndarray, releases: Sequence[Tuple]
                   ) -> Tuple[List[int], np.ndarray]:
    """Group sorted ``(time, node_idx, per_node_vec)`` release tuples by
    distinct release time into ``(times, deltas[M, N, R])`` — the dense
    input layout of the prefix-scan kernel."""
    times: List[int] = []
    deltas: List[np.ndarray] = []
    cur_t = None
    for t, idx, vec in releases:
        if t != cur_t:
            times.append(t)
            deltas.append(np.zeros_like(avail))
            cur_t = t
        deltas[-1][idx] += vec[None, :]
    if not deltas:
        return times, np.zeros((0,) + avail.shape, dtype=np.int32)
    return times, np.stack(deltas).astype(np.int32)


def shadow_from_releases(avail: np.ndarray, head_vec: np.ndarray,
                         n_nodes: int, releases: Sequence[Tuple], device
                         ) -> Tuple[Optional[int], Optional[np.ndarray]]:
    """Earliest estimated time the blocked head fits, and the availability
    at that instant — ``EasyBackfilling._shadow`` semantics on the batched
    fit-count scan (one kernel launch on ``device`` regardless of release
    count)."""
    if not releases:
        return None, None
    from . import ops  # local: ops imports this module at load time

    times, deltas = group_releases(avail, releases)
    fits = ops.ebf_shadow_fits(avail, deltas, head_vec, device)
    hit = np.nonzero(fits >= n_nodes)[0]
    if hit.shape[0] == 0:
        return None, None
    m = int(hit[0])
    shadow_avail = avail + deltas[: m + 1].sum(axis=0)
    return times[m], shadow_avail
