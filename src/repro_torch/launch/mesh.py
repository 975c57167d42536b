"""Production mesh definitions.

``make_production_mesh`` is a FUNCTION (not a module constant) so that
importing this module never touches ``torch.distributed``: the dry-run
makes its world of ranks when it first asks for a mesh; everything else
(the smoke, the benches) never makes one.

The world is a fake process group (``torch.testing``'s ``FakeStore`` and
``"fake"`` backend) of ``WORLD_SIZE`` ranks in which this process is
rank 0: the counterpart of the reference's 512 placeholder host devices.
It runs no collective and moves no byte, so a ``DeviceMesh`` on it places
DTensors whose local shards are rank 0's, and the dry-run traces on
``meta`` tensors.  It is made once per process, at the size of the
largest mesh (2 × 16 × 16); smaller meshes take its first ranks.

Topology model: the meshes keep the reference's shapes and axis names,
(16, 16) and (2, 16, 16), so records stay comparable cell for cell, and
the constants below are one H100 SXM5's.  The collective term prices
every byte at ``ICI_BW_PER_LINK``, one NVLink-4 link.  On H100 nodes of
8 GPUs a ``model`` axis of 16 spans two NVLink domains, whose traffic
between them crosses the slower inter-node network: one per-link figure
does not model that, so collective terms over 16-way axes are a lower
bound.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch

#: ranks in the fake world: the largest mesh's (2 pods × 16 × 16)
WORLD_SIZE = 512


def world() -> int:
    """Make the fake world of ``WORLD_SIZE`` ranks if this process has
    none (rank 0); return its size.  A world made otherwise is kept."""
    import torch.distributed as dist
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=WORLD_SIZE)
    return dist.get_world_size()


@functools.lru_cache(maxsize=None)
def _mesh(shape: Sequence[int], names: Sequence[str]):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    if n > world():
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the world "
                         f"has {world()}")
    ranks = torch.arange(n).reshape(tuple(shape))
    return DeviceMesh("cpu", ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    pods: Optional[int] = None):
    """Small mesh for CI-scale sharding tests (the first ranks of the
    world)."""
    if pods:
        return _mesh((pods, n_data, n_model), ("pod", "data", "model"))
    return _mesh((n_data, n_model), ("data", "model"))


def make_mesh(shape: Sequence[int], names: Sequence[str]):
    """A mesh of any shape on the world's first ranks (e.g. the 1 × 1
    mesh of a one-card step)."""
    return _mesh(tuple(shape), tuple(names))


def fleet_mesh(n_sims: Optional[int] = None) -> List[torch.device]:
    """The local CUDA devices a fleet grid is split over (the reference's
    1-D ``"sims"`` mesh): the first ``n_sims`` of them, all by default.
    ``FleetRunner(devices=...)`` advances one part of the grid on each;
    a one-process ``DeviceMesh`` cannot span several local cards, so
    this is a device list, not a mesh."""
    n = n_sims or torch.cuda.device_count()
    if not 0 < n <= torch.cuda.device_count():
        raise ValueError(f"{n} devices asked, {torch.cuda.device_count()} "
                         "visible")
    return [torch.device("cuda", i) for i in range(n)]


# H100 SXM5 hardware constants (roofline denominators)
PEAK_FLOPS_BF16 = 989e12          # dense BF16 tensor core, per GPU (NVIDIA H100 datasheet, SXM5)
HBM_BW = 3.35e12                  # bytes/s per GPU, HBM3 (NVIDIA H100 datasheet, SXM5)
ICI_BW_PER_LINK = 25e9            # bytes/s per NVLink-4 link per direction (18 links, 900 GB/s both ways; NVIDIA H100 datasheet)
HBM_PER_CHIP = 80 * 10 ** 9       # H100 SXM5: 80 GB HBM3
