"""Logical-axis sharding rules (MaxText-style), mesh-shape agnostic.

Model code names tensor axes logically (``batch``, ``embed``, ``heads``,
``mlp``, ``experts`` …).  A *rule set* maps logical names to mesh axes;
``logical_to_spec`` prunes axes absent from the active mesh, so the same
model runs on ``(data, model)``, ``(pod, data, model)`` or a single
device unchanged.

Rule sets double as the perf-iteration knob (§Perf): the baseline is
FSDP(data) × TP(model); alternates re-shard specific axes.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry
per tensor dim, each ``None``, a mesh axis name, or a tuple of names.
On a ``torch.distributed`` ``DeviceMesh`` a spec becomes DTensor
placements, one per mesh dim (:func:`spec_to_placements`), and
:func:`shard` redistributes a DTensor to them, as the reference's
``with_sharding_constraint``.  Without active rules, or on a plain
tensor, ``shard`` returns its input: every path that runs outside the
dry-run is unchanged.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]

# Logical axis -> mesh axes (tuples try each; pruned to the live mesh)
RULE_SETS: Dict[str, Dict[str, Axis]] = {
    # FSDP over 'data' (params/optimizer sharded), TP over 'model',
    # batch over (pod, data).
    "baseline": {
        "batch": ("pod", "data"),
        "seq": None,
        "embed": "data",          # FSDP axis for params
        "embed_act": None,        # activations keep embed unsharded
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_embed": "data",
        "expert_mlp": None,
        "cap": None,
        "groups": ("pod", "data"),
        "layers": None,
        "conv": None,
        "state": None,
        "inner": "model",         # mamba d_inner
        "cache_batch": ("pod", "data"),
        "cache_seq": "model",
        "cache_heads": None,
    },
    # Sequence parallelism: shard long sequences over 'model' for
    # activations (attention re-gathers K/V internally).
    "seqparallel": {
        "batch": ("pod", "data"),
        "seq": "model",
        "embed": "data",
        "embed_act": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_embed": "data",
        "expert_mlp": None,
        "cap": None,
        "groups": ("pod", "data"),
        "layers": None,
        "conv": None,
        "state": None,
        "inner": "model",
        "cache_batch": ("pod", "data"),
        "cache_seq": "model",
        "cache_heads": None,
    },
    # Expert/FSDP parallelism without tensor-parallel activations: batch
    # over (pod, data), sequence over model, experts over model; dense
    # weights ZeRO-gathered per layer.  Kills the per-layer activation
    # all-reduces that dominate the collective term for MoE training.
    "ep_fsdp": {
        "batch": ("pod", "data"),
        "seq": "model",
        "embed": "data",
        "embed_act": None,
        "heads": None,
        "kv_heads": None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_embed": "data",
        "expert_mlp": None,
        "cap": None,
        "groups": ("pod", "data"),
        "layers": None,
        "conv": None,
        "state": None,
        "inner": "model",
        "cache_batch": ("pod", "data"),
        "cache_seq": "model",
        "cache_heads": None,
    },
    # Pure ZeRO-3 data parallelism: batch over EVERY mesh axis, weights
    # 2D-sharded and gathered per layer, no tensor-parallel activations
    # at all.  For models whose per-layer weights are small relative to
    # activation all-reduce traffic (the dense <20B class).
    "zero3": {
        "batch": ("pod", "data", "model"),
        "seq": None,
        "embed": "data",
        "embed_act": None,
        "heads": None,
        "kv_heads": None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_embed": "data",
        "expert_mlp": None,
        "cap": None,
        "groups": ("pod", "data", "model"),
        "layers": None,
        "conv": None,
        "state": None,
        "inner": "model",
        "cache_batch": ("pod", "data"),
        "cache_seq": "model",
        "cache_heads": None,
    },
    # zero3 + tensor-parallel-WITHIN-expert: expert f dim sharded over
    # 'data' so expert weights are never gathered; the per-expert matmul
    # pays a partial-sum all-reduce on [E_loc, C, d] activations instead
    # (cheaper than weight gathers once tokens-per-expert > d·f/(d+f)).
    "moe_ep2d": {
        "batch": ("pod", "data", "model"),
        "seq": None,
        "embed": "data",
        "embed_act": None,
        "heads": None,
        "kv_heads": None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_embed": None,
        "expert_mlp": "data",
        "cap": None,
        "groups": ("pod", "data", "model"),
        "layers": None,
        "conv": None,
        "state": None,
        "inner": "model",
        "cache_batch": ("pod", "data"),
        "cache_seq": "model",
        "cache_heads": None,
    },
    # Pure expert parallelism for small-expert MoE (qwen3-moe class):
    # expert weights live WHOLE on their model shard (no d/f sharding,
    # no gathers, no TP-within-expert) — tokens all-to-all to experts.
    "moe_ep": {
        "batch": ("pod", "data", "model"),
        "seq": None,
        "embed": "data",
        "embed_act": None,
        "heads": None,
        "kv_heads": None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_embed": None,
        "expert_mlp": None,
        "cap": None,
        "groups": ("pod", "data", "model"),
        "layers": None,
        "conv": None,
        "state": None,
        "inner": "model",
        "cache_batch": ("pod", "data"),
        "cache_seq": "model",
        "cache_heads": None,
    },
    # 2D-sharded params (data+model on the big matmul dims) for very
    # large archs where pure TP leaves >HBM per chip.
    "fsdp_tp_2d": {
        "batch": ("pod", "data"),
        "seq": None,
        "embed": "data",
        "embed_act": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": ("data", "model"),
        "expert_embed": "data",
        "expert_mlp": None,
        "cap": None,
        "groups": ("pod",),
        "layers": None,
        "conv": None,
        "state": None,
        "inner": "model",
        "cache_batch": ("pod", "data"),
        "cache_seq": "model",
        "cache_heads": None,
    },
}


# Multi-pod variants of the data-parallel-everywhere sets: with the
# global batch fixed at 256 and 512 chips, per-chip batch would be 0.5 —
# instead the SEQUENCE splits across the pod axis (2048 tokens/chip),
# keeping every chip busy at the cost of cross-pod KV gathers.
for _name in ("zero3", "moe_ep", "moe_ep2d"):
    _m = dict(RULE_SETS[_name])
    _m["batch"] = ("data", "model")
    _m["seq"] = "pod"
    _m["groups"] = ("data", "model")
    RULE_SETS[_name + "_multi"] = _m
del _name, _m


class _Ctx(threading.local):
    mesh = None
    rules: Optional[Dict[str, Axis]] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(mesh, rules: Union[str, Dict[str, Axis]] = "baseline"):
    """Activate a mesh + rule set for ``shard``/``logical_to_spec``
    (per thread; nested uses restore the outer one on exit)."""
    if isinstance(rules, str):
        rules = RULE_SETS[rules]
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_rules():
    return _CTX.mesh, _CTX.rules


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh: anything with ``axis_names`` and
    ``devices.shape`` (the reference's mesh and its stand-ins), or a
    ``DeviceMesh`` (``mesh_dim_names`` and ``shape``)."""
    if hasattr(mesh, "axis_names"):
        return dict(zip(mesh.axis_names, mesh.devices.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    mesh=None,
    rules: Optional[Dict[str, Axis]] = None,
    dims: Optional[Sequence[int]] = None,
) -> Spec:
    """Map logical axis names to a spec valid on ``mesh``.

    When ``dims`` (the tensor shape) is given, mesh axes whose product does
    not divide the dimension are dropped from the tail — e.g. a KV-head
    dim of 8 on a 16-way ``model`` axis falls back to replication, and a
    batch of 1 drops the ``(pod, data)`` axes entirely.  Each mesh axis
    shards at most one dim.
    """
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None or rules is None:
        return ()
    sizes = mesh_axes(mesh)
    used: set = set()
    parts = []
    for i, name in enumerate(logical_axes):
        axis = rules.get(name) if name else None
        if axis is None:
            parts.append(None)
            continue
        cands = axis if isinstance(axis, tuple) else (axis,)
        picked = [a for a in cands if a in sizes and a not in used]
        if dims is not None and i < len(dims):
            while picked:
                prod = 1
                for a in picked:
                    prod *= sizes[a]
                if dims[i] % prod == 0:
                    break
                picked.pop()
        used.update(picked)
        if not picked:
            parts.append(None)
        elif len(picked) == 1:
            parts.append(picked[0])
        else:
            parts.append(tuple(picked))
    return tuple(parts)


def spec_to_placements(spec: Spec, mesh) -> Tuple:
    """DTensor placements on the ``DeviceMesh`` ``mesh`` for ``spec``:
    ``Shard(i)`` on every mesh dim that shards tensor dim ``i``,
    ``Replicate()`` on the others.  A dim sharded over several mesh axes
    (``("pod", "data")``) is split in the tuple's order, which must be
    the mesh's."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, part in enumerate(spec):
        axes = (part,) if isinstance(part, str) else (part or ())
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {part!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for j in pos:
            out[j] = Shard(i)
    return tuple(out)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(i, (str, type(None))) for i in x)


def map_axes(fn, axes_tree, *others):
    """``fn(axes, *leaves)`` over a tree of logical-axes tuples (dicts,
    lists, named tuples; ``None`` stays ``None``), with ``others`` trees
    of the same structure."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *others)
    if axes_tree is None:
        return None
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(o[k] for o in others))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        out = [map_axes(fn, v, *(o[i] for o in others))
               for i, v in enumerate(axes_tree)]
        if hasattr(axes_tree, "_fields"):
            return type(axes_tree)(*out)
        return type(axes_tree)(out)
    raise TypeError(f"not an axes tree node: {type(axes_tree).__name__}")


def shardings_from_axes(axes_tree, mesh,
                        rules: Union[str, Dict[str, Axis]] = "baseline",
                        shapes_tree=None):
    """Map a tree of logical-axes tuples to placements tuples on the
    ``DeviceMesh`` ``mesh``.

    With ``shapes_tree`` (a matching tree of tensors or of anything with
    ``shape``), non-divisible mesh axes are pruned per-dimension (see
    ``logical_to_spec``)."""
    if isinstance(rules, str):
        rules = RULE_SETS[rules]

    def mk(axes, shp=None):
        dims = tuple(shp.shape) if hasattr(shp, "shape") else None
        return spec_to_placements(logical_to_spec(axes, mesh, rules, dims),
                                  mesh)

    if shapes_tree is None:
        return map_axes(mk, axes_tree)
    return map_axes(mk, axes_tree, shapes_tree)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Annotate an activation with its logical sharding (no-op without
    rules, and on a tensor that is not a DTensor).  A DTensor is
    redistributed to the spec pruned against its shape, on its own
    mesh."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(logical_axes, x.device_mesh, rules,
                           dims=tuple(x.shape))
    placements = spec_to_placements(spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def local_shard(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This device's shard of ``t`` placed on ``mesh`` as ``placements``:
    a DTensor is redistributed there, a plain tensor is taken as
    replicated.  The per-shard computations of the models (attention,
    the scan, the MoE's routing) read their inputs through it."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        if all(p == Replicate() for p in placements):
            return t
        t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, tuple(placements)).to_local()


def weight_for(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``w`` placed for the product ``x @ w`` (contraction over ``x``'s
    last dim and ``w``'s second to last): with DTensors, a weight whose
    contraction dim is sharded on a mesh dim that shards the activation's
    rows (dim 0: FSDP, weights over the data axis beside a batch over it)
    is gathered there, so the weights move and the activations stay, as a
    partitioner gathers an FSDP weight at its use; anything else is
    returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(w, DTensor) and isinstance(x, DTensor)):
        return w
    wk = Shard(w.ndim - 2)
    place = tuple(Replicate() if p == wk and xp == Shard(0) else p
                  for p, xp in zip(w.placements, x.placements))
    if place == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, place)


def splittable(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` placed so that dim ``dim`` can be viewed as ``n`` × rest, in
    the forward pass and for its gradient in the backward one: a DTensor
    keeps its shards of ``dim`` while their count divides ``n`` (in mesh
    order) and is gathered along it past that (a sharded compiler
    reshards there as well: e.g. 4 heads of a projection sharded 16
    ways); a plain tensor is returned as it is.  Put it before a view
    that splits ``dim``, or after one that merges it (for the backward's
    split)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return _Splittable.apply(x, dim % x.ndim, n)


def _fit(x, dim: int, n: int):
    from torch.distributed.tensor import Replicate, Shard
    mesh, count, place = x.device_mesh, 1, []
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            if n % (count * mesh.size(m)) == 0:
                count *= mesh.size(m)
            else:
                p = Replicate()
        place.append(p)
    if tuple(place) == tuple(x.placements):
        return x
    return x.redistribute(mesh, place)


class _Splittable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.fit = (dim, n)
        return _fit(x, dim, n)

    @staticmethod
    def backward(ctx, grad):
        return _fit(grad, *ctx.fit), None, None
