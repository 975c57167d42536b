"""EASY-backfilling shadow-time computation (CUDA kernel + host driver).

The paper's measured hot spot (Table 2: EBF spends 21:41 of 22:24 total in
dispatching) is the shadow-time computation: walk release events of
running jobs in estimated-release order, accumulate freed resources, and
find the first prefix at which the blocked head job fits.

* :func:`ebf_shadow` — the kernel wrapper.  Release events grouped by
  distinct release time form M groups; the releases arrive sparse,
  grouped by node (:class:`SparseReleases`), and the kernel
  (``csrc/ebf_shadow.cu``) counts, per group prefix, the nodes whose
  cumulative availability fits the head's request.
* :func:`shadow_from_releases` — the host-path driver on top of it:
  turns the ``(time, nodes, vec)`` release tuples into that layout
  (:func:`sparse_releases`), launches the fit-count scan
  (``ops.ebf_shadow_fits``), and returns ``(shadow_time,
  shadow_avail)`` — what ``VectorizedEasyBackfilling`` calls per blocked
  head.

Semantics are the tie-grouped prefix scan: every release sharing a
timestamp is applied before the fit test.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build, counters, ref

#: largest resource-type count the kernel keeps in registers
MAX_R = 8


def shared_m() -> int:
    """Largest group count whose per-group fit changes the kernel sums in
    shared memory (``kSharedM`` in the source, read from the built
    library); above it, in the output."""
    return build.library("ebf_shadow").ebf_shadow_shared_m()


def ebf_shadow(avail: torch.Tensor, node_ptr: torch.Tensor,
               entry_m: torch.Tensor, entry_vec: torch.Tensor,
               req: torch.Tensor, m: int) -> torch.Tensor:
    """fits int32[M]: fitting-node count per release-group prefix.

    ``avail int32[N, R]``, ``req int32[R]``; node n's releases are entries
    ``node_ptr[n] .. node_ptr[n+1]-1`` (``node_ptr int32[N+1]``, from 0 to
    nnz), each a group index ``entry_m int32[nnz]`` in ``[0, m)``, not
    decreasing within a node, and a vector ``entry_vec int32[nnz, R]``.
    Releases that break these rules are malformed, and then every count
    is -1 (nothing is read out of bounds).  A CUDA tensor launches the
    kernel (or raises); a CPU tensor runs the plain version.
    """
    dev = avail.device
    build.check_input(avail, "avail", 2, dev)
    build.check_input(node_ptr, "node_ptr", 1, dev)
    build.check_input(entry_m, "entry_m", 1, dev)
    build.check_input(entry_vec, "entry_vec", 2, dev)
    build.check_input(req, "req", 1, dev)
    n, r = avail.shape
    nnz = entry_m.shape[0]
    if (r < 1 or req.shape[0] != r or node_ptr.shape[0] != n + 1
            or tuple(entry_vec.shape) != (nnz, r) or m < 0):
        raise ValueError(f"shapes avail {tuple(avail.shape)}, node_ptr "
                         f"{tuple(node_ptr.shape)}, entry_m ({nnz},), "
                         f"entry_vec {tuple(entry_vec.shape)}, req "
                         f"{tuple(req.shape)}, m {m}")
    if not build.launch_target(dev):
        return ref.ebf_shadow_sparse_ref(avail, node_ptr, entry_m, entry_vec,
                                         req, m)
    if r > MAX_R:
        raise ValueError(f"ebf_shadow kernel takes R <= {MAX_R}, got {r}")
    fits = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return fits
    lib = build.library("ebf_shadow")
    index = build.device_index(dev)
    stream = torch.cuda.current_stream(index).cuda_stream
    build.check(lib.ebf_shadow_launch(
        avail.data_ptr(), req.data_ptr(), node_ptr.data_ptr(),
        entry_m.data_ptr(), entry_vec.data_ptr(), fits.data_ptr(), m, n, r,
        nnz, index, stream), "ebf_shadow")
    counters.record_device("ebf_shadow")
    return fits


# ----------------------------------------------------------------------
# host path: release tuples -> (shadow_time, shadow_avail)
# ----------------------------------------------------------------------
class SparseReleases(NamedTuple):
    """Sorted release tuples, grouped by distinct time and by node."""
    times: np.ndarray        # int64[M]   distinct release times, ascending
    node_ptr: np.ndarray     # int64[N+1] node n's entries: ptr[n]..ptr[n+1]-1
    entry_node: np.ndarray   # int64[nnz] node of each entry (host only)
    entry_m: np.ndarray      # int64[nnz] group index, rising within a node
    entry_vec: np.ndarray    # [nnz, R]   released per-node vector


def sparse_releases(n_nodes: int, releases: Sequence[Tuple]
                    ) -> SparseReleases:
    """Group sorted ``(time, node_idx, per_node_vec)`` release tuples by
    distinct release time (group m) and by node, with a stable sort by
    node over the release order, so a node's entries keep rising m.  The
    nodes of one tuple are distinct (a job holds each of its nodes
    once)."""
    ts, lens, nodes, vecs = [], [], [], []
    for t, idx, vec in releases:
        ts.append(t)
        lens.append(len(idx))
        nodes.append(idx)
        vecs.append(vec)
    ts = np.asarray(ts, dtype=np.int64)
    first = np.ones(ts.shape, dtype=bool)
    first[1:] = ts[1:] != ts[:-1]
    group = np.cumsum(first) - 1
    node = np.concatenate(nodes).astype(np.int64) if nodes \
        else np.zeros(0, np.int64)
    if node.size and (node.min() < 0 or node.max() >= n_nodes):
        raise ValueError(f"release node ids outside [0, {n_nodes})")
    order = np.argsort(node, kind="stable")
    node_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(node, minlength=n_nodes), out=node_ptr[1:])
    return SparseReleases(
        times=ts[first], node_ptr=node_ptr, entry_node=node[order],
        entry_m=np.repeat(group, lens)[order],
        entry_vec=np.repeat(np.asarray(vecs), lens, axis=0)[order])


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

    rel = sparse_releases(avail.shape[0], releases)
    fits = ops.ebf_shadow_fits(avail, rel, head_vec, device)
    hit = np.nonzero(fits >= n_nodes)[0]
    if hit.shape[0] == 0:
        return None, None
    m = int(hit[0])
    upto = rel.entry_m <= m
    shadow_avail = avail.copy()
    np.add.at(shadow_avail, rel.entry_node[upto], rel.entry_vec[upto])
    return int(rel.times[m]), shadow_avail


# ----------------------------------------------------------------------
# the fleet engine's walk: one release per trip
# ----------------------------------------------------------------------
#: the fleet engine's +infinity sentinel (``fleet.state.INF_I``)
INF_I = 1 << 30


def shadow_walk(avail: torch.Tensor, rel: torch.Tensor,
                assigned: torch.Tensor, req: torch.Tensor,
                head_req: torch.Tensor, need: int,
                node_ok: Optional[torch.Tensor] = None):
    """The fleet engine's shadow scan over its row arrays, in plain
    PyTorch: the semantics of :func:`shadow_from_releases`.

    ``avail int32[N, R]`` is the availability the walk starts from;
    ``rel int32[M]`` the per-row estimated release times, ``INF_I`` on
    every row that takes no part (an all-INF ``rel`` walks nothing);
    ``assigned int32[M, K]`` node ids padded with N; ``req int32[M, R]``;
    ``head_req int32[R]`` and ``need`` the blocked head's request.
    ``node_ok bool[N]`` (optional) leaves ineligible (down or
    quarantined) nodes out of the fit count.

    Each trip releases the earliest-releasing row (the lowest row on
    ties) and, only once no remaining row shares its timestamp, counts
    the fitting nodes.  Returns ``(found, shadow_time, shadow_avail)``:
    the availability after the last group released (every row's release
    when the head never fits, and then ``shadow_time`` is 0).  The CUDA
    fleet engine carries the same walk as a device function.
    """
    n = avail.shape[0]
    cur = avail.clone()
    rel = rel.clone()
    found, sh_t = False, 0
    j = int(torch.argmin(rel))
    t_j = int(rel[j])
    while not found and t_j < INF_I:
        nodes = assigned[j].long()
        nodes = nodes[nodes < n]
        cur.index_add_(0, nodes, req[j].expand(nodes.shape[0], -1))
        rel[j] = INF_I
        j = int(torch.argmin(rel))
        t2 = int(rel[j])
        if t2 > t_j:
            fitn = (cur >= head_req[None, :]).all(dim=1)
            if node_ok is not None:
                fitn = fitn & node_ok
            if int(fitn.sum()) >= need:
                found, sh_t = True, t_j
        t_j = t2
    return found, sh_t, cur
