"""Multi-pod dry-run of every (architecture × shape × mesh) cell.

For every (architecture × input shape × mesh) cell this:
  1. places the parameters, AdamW state and inputs (or decode cache) as
     DTensors on ``meta`` over a mesh of the fake world of ranks
     (``launch/mesh.py``), by the logical-axis rules,
  2. traces the step (train_step with micro-batches and remat / prefill
     / decode) once, eagerly: no allocation, nothing computed, no kernel
     launched, on the CPU or on the card,
  3. records the per-device memory (argument, output and peak temporary
     bytes; ``fits_16gib_hbm`` keeps the reference's key for its readers
     and tests against ``HBM_PER_CHIP``, one H100's 80 GB) and the cost
     model's FLOPs / bytes / collective bytes by kind (``hlo_analysis``),
     with the three-term roofline from the H100 constants of
     ``launch/mesh.py``,
  4. writes one JSON per cell under ``results/dryrun/``.

Plain tensors that the models build inside the step (positions, masks,
``arange``s, the sinusoid tables) meet the DTensor activations as
replicated tensors: the trace runs under DTensor's
``implicit_replication``.  Failures are recorded, not raised.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
      --shape all --mesh both --rules baseline --out results/dryrun
"""
import argparse
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch

from ..configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from ..configs.base import ShapeSpec
from ..kernels import ops
from ..models import build_model
from ..serving.serve_step import make_decode_step, make_prefill_step
from ..sharding import shardings_from_axes, use_rules
from ..training import AdamWConfig, TrainStepConfig, make_train_step
from ..training.optimizer import (AdamWState, named_axes, named_params,
                                  opt_state_logical_axes)
from .hlo_analysis import counting
from .mesh import (HBM_PER_CHIP, ICI_BW_PER_LINK, PEAK_FLOPS_BF16, HBM_BW,
                   make_debug_mesh, make_production_mesh)

# microbatch defaults per shape kind (activation-memory knob; §Perf)
DEFAULT_MICROBATCHES = {"train": 4, "prefill": 1, "decode": 1}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference); N active for MoE."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.tokens
        return 6.0 * n * d
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch          # decode: 1 token/sample


def _place(tensors, placements, mesh, requires_grad=False):
    """A tree of meta tensors (global shapes) as DTensors on ``mesh``
    with a matching tree of placements (rank 0's local shards)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def one(t, pl):
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        loc = torch.empty(local, dtype=t.dtype, device="meta")
        d = DTensor.from_local(loc, mesh, pl, run_check=False,
                               shape=t.shape, stride=t.stride())
        return d.requires_grad_() if requires_grad else d

    if isinstance(tensors, torch.Tensor):
        return one(tensors, placements)
    if isinstance(tensors, dict):
        return {k: _place(v, placements[k], mesh, requires_grad)
                for k, v in tensors.items()}
    if isinstance(tensors, list):
        return [_place(v, p, mesh, requires_grad)
                for v, p in zip(tensors, placements)]
    raise TypeError(type(tensors).__name__)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """Per-device bytes of a tree of (D)Tensors: rank 0's shards."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _leaves(tree))


class _Live:
    """Live bytes of the storages that ops make during a trace, and their
    peak: a storage counts from the op that makes it until its last
    tensor is freed; the argument storages never count."""

    def __init__(self, args) -> None:
        self.outside = {_local(t).untyped_storage()._cdata
                        for t in _leaves(args)}
        self.owners: Dict[int, list] = {}
        self.live = self.peak = 0

    def seen(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.outside:
            return
        if key not in self.owners:
            self.owners[key] = [st.nbytes(), 0]
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        self.owners[key][1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        own = self.owners.get(key)
        if own is None:
            return
        own[1] -= 1
        if own[1] == 0:
            self.live -= own[0]
            del self.owners[key]

    def new_bytes(self, tree) -> int:
        """Bytes of the storages in ``tree`` that the trace made."""
        keys = {_local(t).untyped_storage()._cdata for t in _leaves(tree)}
        return sum(self.owners[k][0] for k in keys if k in self.owners)


def build_cell(arch: str, shape_name, mesh, rules: str,
               microbatches: Optional[int], smoke: bool = False,
               remat: str = "full", state_dtype: str = "float32",
               moe_group_size: Optional[int] = None,
               kv_cache_dtype: str = ""):
    """(cfg, shape, step, args, mb, donated): ``step(*args)`` traces the
    cell's step on DTensors placed on ``mesh`` by ``rules``; ``donated``
    are the arguments the reference donates (train: parameters and
    optimizer state; decode: the cache).  ``shape_name`` may also be a
    ``ShapeSpec`` of the caller's own."""
    cfg = get_config(arch, smoke=smoke)
    if moe_group_size:
        cfg = cfg.replace(moe_group_size=moe_group_size)
    if kv_cache_dtype:
        cfg = cfg.replace(kv_cache_dtype=kv_cache_dtype)
    model = build_model(cfg, "meta")
    shape = shape_name if isinstance(shape_name, ShapeSpec) \
        else SHAPES[shape_name]
    mb = microbatches or DEFAULT_MICROBATCHES[shape.kind]

    paxes = model.param_logical_axes()
    pshapes = model.param_shapes()
    p_sh = shardings_from_axes(paxes, mesh, rules, pshapes)
    train = shape.kind == "train"
    params = model._module(_place(pshapes, p_sh, mesh, requires_grad=train))
    if not train:
        params.requires_grad_(False)
    ispecs, iaxes = model.input_specs(shape)
    inputs = _place(ispecs, shardings_from_axes(iaxes, mesh, rules, ispecs),
                    mesh)

    if train:
        ocfg = AdamWConfig(state_dtype=state_dtype)
        tcfg = TrainStepConfig(microbatches=mb, remat=remat)
        named = named_params(params)
        oaxes = opt_state_logical_axes(named_axes(paxes), ocfg)
        sdt = getattr(torch, state_dtype)
        state_shapes = {n: torch.empty(p.shape, dtype=sdt, device="meta")
                        for n, p in named.items()}
        step_sh = shardings_from_axes(oaxes.step, mesh, rules)
        m_sh = shardings_from_axes(oaxes.m, mesh, rules, state_shapes)
        opt = AdamWState(
            step=_place(torch.empty((), dtype=torch.int32, device="meta"),
                        step_sh, mesh),
            m=_place(state_shapes, m_sh, mesh),
            v=_place(state_shapes, m_sh, mesh), ef=None)
        step = make_train_step(model, ocfg, tcfg)
        args = (params, opt, inputs)
        donated = (list(named.values()), opt)
    elif shape.kind == "prefill":
        step = make_prefill_step(model)
        args = (params, inputs)
        donated = ()
    else:  # decode
        cshapes = model.cache_shapes(shape.global_batch, shape.seq_len)
        c_sh = shardings_from_axes(model.cache_logical_axes(), mesh, rules,
                                   cshapes)
        step = make_decode_step(model)
        args = (params, inputs["tokens"], _place(cshapes, c_sh, mesh))
        donated = (args[2],)
    return cfg, shape, step, args, mb, donated


def _arg_leaves(args):
    params = args[0]
    rest = args[1:]
    return list(named_params(params).values()), rest


def trace_cell(cfg, shape, step, args, donated, mesh) -> Dict:
    """Trace ``step(*args)`` once under the cost model: the record's
    ``memory`` and ``hlo`` parts and the cost totals."""
    from torch.distributed.tensor.experimental import implicit_replication
    leaves = _arg_leaves(args)
    live = _Live(leaves)
    with implicit_replication(), counting(live.seen) as cost:
        out = step(*args)
    arg_b = local_bytes(leaves)
    out_b = local_bytes(out if not isinstance(out[0], torch.nn.Module)
                        else (list(named_params(out[0]).values()), out[1:]))
    alias_b = local_bytes(donated)
    temp_b = max(live.peak - live.new_bytes(out), 0)
    per_dev = arg_b + out_b + temp_b - alias_b
    return {
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "alias_bytes": alias_b,
            "per_device_bytes": int(per_dev),
            "per_device_gib": round(per_dev / 2**30, 3),
            "fits_16gib_hbm": bool(per_dev <= HBM_PER_CHIP),
        },
        "cost": cost,
    }


def run_cell(arch: str, shape_name, mesh_kind: str, rules: str,
             microbatches: Optional[int] = None, smoke: bool = False,
             remat: str = "full", state_dtype: str = "float32",
             scan_impl: str = "ref", moe_group_size: Optional[int] = None,
             kv_cache_dtype: str = "", tag: Optional[str] = None,
             mesh=None) -> Dict:
    """One cell's record.  ``mesh_kind`` is ``"single"``, ``"multi"`` or
    ``"debug"`` (4 × 2); a caller's own ``mesh`` overrides it (and names
    the record's ``mesh`` by ``mesh_kind`` all the same).  ``lower_s`` is
    the time to place the arguments, ``compile_s`` the trace's."""
    if mesh is None:
        if mesh_kind == "debug":            # CI-scale: 8 ranks
            mesh = make_debug_mesh(4, 2)
        else:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = mesh.size()
    shape_key = shape_name.name if isinstance(shape_name, ShapeSpec) \
        else shape_name
    rec: Dict = {"arch": arch, "shape": shape_key, "mesh": mesh_kind,
                 "chips": int(chips), "rules": tag or rules,
                 "rules_base": rules, "ok": False,
                 "knobs": {"remat": remat, "state_dtype": state_dtype,
                           "scan_impl": scan_impl,
                           "moe_group_size": moe_group_size}}
    t0 = time.time()
    try:
        with use_rules(mesh, rules), ops.scan_trace(scan_impl):
            cfg, shape, step, args, mb, donated = build_cell(
                arch, shape_name, mesh, rules, microbatches, smoke,
                remat=remat, state_dtype=state_dtype,
                moe_group_size=moe_group_size,
                kv_cache_dtype=kv_cache_dtype)
            rec["microbatches"] = mb
            rec["lower_s"] = round(time.time() - t0, 1)
            t1 = time.time()
            traced = trace_cell(cfg, shape, step, args, donated, mesh)
            rec["compile_s"] = round(time.time() - t1, 1)
            rec["memory"] = traced["memory"]
            cost = traced["cost"]
            # no uncorrected pass exists here: the raw figures are the trace's
            rec["cost_analysis_raw"] = {"flops": float(cost.flops),
                                        "bytes_accessed": float(cost.bytes)}
            rec["hlo"] = {
                "flops_per_device": cost.flops,
                "bytes_per_device": cost.bytes,
                "collective_bytes": dict(cost.collective_bytes),
                "collective_link_bytes": dict(cost.collective_link_bytes),
                "collective_count": dict(cost.collective_count),
            }
            mf = model_flops(cfg, shape)
            compute_s = cost.flops / PEAK_FLOPS_BF16
            memory_s = cost.bytes / HBM_BW
            coll_s = cost.total_collective_link_bytes / ICI_BW_PER_LINK
            dominant = max(
                (("compute", compute_s), ("memory", memory_s),
                 ("collective", coll_s)), key=lambda kv: kv[1])[0]
            rec["roofline"] = {
                "compute_s": compute_s,
                "memory_s": memory_s,
                "collective_s": coll_s,
                "dominant": dominant,
                "model_flops_global": mf,
                "model_flops_per_chip": mf / chips,
                "useful_flops_ratio": (mf / chips) / cost.flops if cost.flops else 0.0,
                "bound_step_time_s": max(compute_s, memory_s, coll_s),
            }
            rec["ok"] = True
    except Exception as e:  # record the failure, don't kill the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--rules", default="baseline")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        cfg = get_config(arch, smoke=args.smoke)
        shapes = (applicable_shapes(cfg) if args.shape == "all"
                  else args.shape.split(","))
        skipped = set(SHAPES) - set(applicable_shapes(cfg))
        for sk in sorted(skipped):
            if args.shape == "all":
                print(f"[skip] {arch} × {sk}: quadratic attention @ 524k "
                      f"(DESIGN.md §Arch-applicability)")
        for shape_name in shapes:
            for mesh_kind in meshes:
                tag = f"{arch}__{shape_name}__{mesh_kind}__{args.rules}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    n_skip += 1
                    continue
                rec = run_cell(arch, shape_name, mesh_kind, args.rules,
                               args.microbatches or None, smoke=args.smoke)
                with open(path, "w") as fh:
                    json.dump(rec, fh, indent=1)
                if rec["ok"]:
                    n_ok += 1
                    r = rec["roofline"]
                    print(f"[ok]   {tag}: compile={rec['compile_s']}s "
                          f"mem/dev={rec['memory']['per_device_gib']}GiB "
                          f"dominant={r['dominant']} "
                          f"bound={r['bound_step_time_s']:.4f}s "
                          f"useful={r['useful_flops_ratio']:.2f}")
                else:
                    n_fail += 1
                    print(f"[FAIL] {tag}: {rec['error']}")
    print(f"done: ok={n_ok} fail={n_fail} skip={n_skip}")


if __name__ == "__main__":
    main()
