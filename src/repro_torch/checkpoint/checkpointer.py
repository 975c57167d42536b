"""Checkpointing with restart.

Layout (the reference's): ``<dir>/step_<N>/`` holding one ``.npy`` per
tree leaf (path joined with ``__`` in the filename) plus
``manifest.json`` with ``step``, ``leaves`` (shape and dtype of each),
``shards`` and ``metadata``.  Leaves are copied to host memory first, so
the files can be written on a background thread while the next step
runs on the card.

Trees are dicts, lists, NamedTuples and ``nn.Module``s (their
parameters, by dotted name); ``None`` is skipped.  numpy has no
bfloat16, so a bfloat16 leaf is stored as its raw ``uint16`` bits with
``"bfloat16"`` as its manifest dtype, and restored bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "__"


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    if isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            out.append((prefix + tuple(name.split(".")), p))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flatten(tree[k], prefix + (str(k),)))
    elif hasattr(tree, "_fields"):            # NamedTuple
        for k in tree._fields:
            out.extend(_flatten(getattr(tree, k), prefix + (k,)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.extend(_flatten(v, prefix + (str(i),)))
    elif tree is None:
        pass
    else:
        out.append((prefix, tree))
    return out


@dataclass(frozen=True)
class _HostLeaf:
    """A leaf copied to host memory: its array and manifest dtype."""
    array: np.ndarray
    dtype: str


def _to_host(leaf) -> _HostLeaf:
    """A copy of ``leaf`` in host memory (bfloat16 as its uint16 bits);
    later in-place updates of the leaf do not reach it."""
    if isinstance(leaf, _HostLeaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return _HostLeaf(t.view(torch.int16).numpy().view(np.uint16),
                             dtype)
        return _HostLeaf(t.numpy(), dtype)
    arr = np.array(leaf)
    return _HostLeaf(arr, str(arr.dtype))


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _unflatten_into(skeleton, flat: Dict[str, torch.Tensor], prefix=()):
    """``skeleton``'s structure with each leaf restored on the skeleton
    leaf's device; an ``nn.Module``'s parameters are restored in place
    and the module returned."""
    def take(key, like):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = flat[key]
        if isinstance(like, torch.Tensor):
            if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
                raise ValueError(f"{key}: {t.dtype}{tuple(t.shape)} in the "
                                 f"checkpoint, {like.dtype}"
                                 f"{tuple(like.shape)} in the skeleton")
            return t.to(like.device)
        return t

    if isinstance(skeleton, torch.nn.Module):
        with torch.no_grad():
            for name, p in skeleton.named_parameters():
                key = SEP.join(prefix + tuple(name.split(".")))
                p.copy_(take(key, p))
        return skeleton
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(v, flat, prefix + (str(k),))
                for k, v in skeleton.items()}
    if hasattr(skeleton, "_fields"):
        return type(skeleton)(*[
            _unflatten_into(getattr(skeleton, k), flat, prefix + (k,))
            for k in skeleton._fields])
    if isinstance(skeleton, list):
        return [_unflatten_into(v, flat, prefix + (str(i),))
                for i, v in enumerate(skeleton)]
    if skeleton is None:
        return None
    return take(SEP.join(prefix), skeleton)


def save_checkpoint(directory: str, step: int, tree, metadata=None,
                    _tmp_suffix: str = ".tmp") -> str:
    """Atomic save: write to ``step_N.tmp`` then rename."""
    final = os.path.join(directory, f"step_{step}")
    tmp = final + _tmp_suffix
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "shards": 1,
                "metadata": metadata or {}}
    for path, leaf in _flatten(tree):
        key = SEP.join(path)
        host = _to_host(leaf)
        np.save(os.path.join(tmp, key + ".npy"), host.array)
        manifest["leaves"][key] = {"shape": list(host.array.shape),
                                   "dtype": host.dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore_checkpoint(directory: str, skeleton, step: Optional[int] = None):
    """Restore into ``skeleton``'s structure: (tree, manifest)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    flat = {}
    for key, meta in manifest["leaves"].items():
        flat[key] = _from_host(np.load(os.path.join(path, key + ".npy")),
                               meta["dtype"])
    return _unflatten_into(skeleton, flat), manifest


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


class Checkpointer:
    """Async checkpoint manager with retention.

    ``save`` snapshots to host memory synchronously (cheap against a
    training step), then writes files on a worker thread; ``wait`` joins
    before exit.
    """

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, metadata=None, blocking: bool = False):
        self.wait()
        host_tree = {SEP.join(path): _to_host(leaf)
                     for path, leaf in _flatten(tree)}

        def work():
            save_checkpoint(self.directory, step, host_tree, metadata)
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, skeleton, step=None):
        self.wait()
        return restore_checkpoint(self.directory, skeleton, step)

    def _gc(self):
        steps = sorted(
            int(d.split("_", 1)[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
