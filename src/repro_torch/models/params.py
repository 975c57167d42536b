"""Generic parameter machinery shared by all model families.

A *spec tree* mirrors the parameter tree with leaves ``(shape,
logical_axes, fan_in_axis)``; nodes are dicts, or lists (one entry per
layer).  From it come the initialization and the carrying of the JAX
reference's weights into the port.  Unlike the reference, whose block
leaves are stacked along a leading ``n_periods`` axis for ``lax.scan``,
the port keeps one entry per layer and loops over layers in Python.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_F32_LEAVES = ("A_log", "D")


def map_specs(fn, tree, prefix=()):
    """The tree with each leaf replaced by ``fn(path, leaf)``, visited
    depth first; a list node contributes its indices to the path."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v, prefix + (i,)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """The SSM's ``A_log`` and ``D`` stay float32 in every model dtype."""
    return torch.float32 if name in _F32_LEAVES else dtype


def init_from_specs(specs: Dict, generator: torch.Generator,
                    dtype: torch.dtype) -> Dict:
    """Random parameters by the reference's rules: norms one, conv and
    dt biases zero, ``A_log = log(1..S)``, ``D`` one, every other leaf
    normal with std ``fan_in ** -0.5`` (0.02 without a fan-in axis),
    drawn in float32 from ``generator`` on its device, then cast."""
    device = generator.device

    def leaf(path, spec):
        shape, _axes, fan = spec
        name = path[-1]
        if name.startswith("ln") or name.endswith("_norm"):
            return torch.ones(shape, dtype=dtype, device=device)
        if name in ("conv_b", "dt_proj_b"):
            return torch.zeros(shape, dtype=dtype, device=device)
        if name == "A_log":
            s = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)
            return torch.log(s).expand(shape).contiguous()
        if name == "D":
            return torch.ones(shape, dtype=torch.float32, device=device)
        scale = 0.02 if fan is None else float(shape[fan]) ** -0.5
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)
    return map_specs(leaf, specs)


def params_from_reference(tree: Mapping[str, Any], specs: Dict,
                          period: int, dtype: torch.dtype,
                          device) -> Dict:
    """The JAX reference's parameter tree, given as numpy arrays, as the
    port's parameters.

    ``tree`` is the reference's layout: block leaves under
    ``tree["blocks"]["L{j}"]`` stacked along a leading ``n_periods``
    axis, so layer ``i`` is entry ``i // period`` of sublayer
    ``i % period``.  ``specs`` is the port's spec tree (one entry per
    layer).  Each leaf keeps the reference's layout (``in_proj [d,
    2*di]`` and so on) and is cast to ``dtype`` (``A_log`` and ``D`` to
    float32).  Every array of ``tree`` must be used exactly once: a
    missing leaf, a leftover one or a wrong shape raises.
    """
    avail: Dict[Tuple, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, prefix + (k,))
            else:
                avail[prefix + (k,)] = np.asarray(v)
    walk(tree, ())
    # rows of each stacked block leaf that a layer has taken
    taken: Dict[Tuple, set] = {}

    def leaf(path, spec):
        if path[0] == "blocks":
            layer, name = path[1], path[2]
            key = ("blocks", f"L{layer % period}", name)
            row = layer // period
        else:
            key, row = path, None
        if key not in avail:
            raise KeyError(f"reference tree has no leaf {'/'.join(key)}")
        arr = avail[key]
        if row is not None:
            if arr.ndim == 0 or row >= arr.shape[0]:
                raise ValueError(f"{'/'.join(key)}: no row {row} in shape "
                                 f"{arr.shape}")
            taken.setdefault(key, set()).add(row)
            arr = arr[row]
        else:
            del avail[key]
        if tuple(arr.shape) != tuple(spec[0]):
            raise ValueError(f"{'/'.join(map(str, path))}: shape "
                             f"{arr.shape}, expected {tuple(spec[0])}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        return t.to(device=device, dtype=_leaf_dtype(path[-1], dtype))

    out = map_specs(leaf, specs)
    left = [k for k in avail
            if len(taken.get(k, ())) != (avail[k].shape[0]
                                         if avail[k].ndim else -1)]
    if left:
        raise ValueError("reference leaves not used: "
                         + ", ".join("/".join(k) for k in sorted(left)))
    return out
