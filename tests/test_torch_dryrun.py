"""The port's dry-run against the reference's, on the CPU.

* The dry-run API of ``Model``: ``input_specs`` (shapes, types, axes),
  ``param_shapes``/``param_logical_axes``, ``cache_shapes`` /
  ``cache_logical_axes`` and AdamW's state axes equal the reference's for
  every ``ARCH_ID`` × applicable shape at full size, block leaves less
  the reference's leading ``"layers"`` axis (exact); ``model_flops``
  equal (exact).
* ``run_cell(..., "debug", "baseline", smoke=True)`` gives ``ok`` for seven
  cells, with FLOPs per device within 5 % of the reference's
  ``build_cell`` compiled on a 4 × 2 mesh of Auto axes in a subprocess
  (its own ``test_small_mesh_lower_compile`` mesh has Explicit axes under
  this jax and fails).
* The cost model reproduces hand-computable costs (the reference's
  ``test_hlo_analyzer_known_costs``): a matmul gives 2MNK within 2 %, an
  L-step loop of M×M products 2M³L within 2 %, and an all-gather, a
  reduce-scatter and an all-reduce over groups of 2, 4, 8 and 16 their
  payload times the reference's ring factor (exact).
* The scan stub counts exactly the streamed u/delta/B/C/y/h_last bytes
  and raises on CPU tensors.
* The hillclimb's and the sweep's cells, tags, knobs and ``knobs_for``
  equal the reference's.
"""
import importlib
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable_shapes as japplicable
from repro.configs import get_config as jget
from repro.models import build_model as jbuild

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hillclimb, optimize_sweep
from repro_torch.launch.hlo_analysis import _collective_link_factor, counting
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _reference(name):
    """A reference launch module, imported without the process-wide
    ``XLA_FLAGS`` it sets at import (512 host devices, which would change
    every later jax test of this process)."""
    prev = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev

CELLS = [("qwen3-1.7b", "train_4k", "ref"),
       ("qwen3-moe-30b-a3b", "train_4k", "ref"),
       ("qwen3-moe-30b-a3b", "decode_32k", "ref"),
       ("whisper-medium", "prefill_32k", "ref"),
       ("jamba-1.5-large-398b", "prefill_32k", "ref"),
       ("jamba-1.5-large-398b", "decode_32k", "ref"),
       ("falcon-mamba-7b", "train_4k", "stub")]


def _tree(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _tree(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _tree(v, path + (i,))
    else:
        yield path, node


def _ref(cfg, tree, path):
    if path[0] == "blocks" and cfg.family != "audio":
        return tree["blocks"][f"L{path[1] % cfg.scan_period}"][path[2]], 1
    if path[0] in ("enc_blocks", "dec_blocks") or path[0] == "blocks":
        return tree[path[0]][path[-1]], 1
    for p in path:
        tree = tree[p]
    return tree, 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dry_run_api_equals_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    m, jm = build_model(cfg, "meta"), jbuild(jcfg)
    jdryrun = _reference("dryrun")

    def same(tree, jtree, axes, jaxes):
        n = 0
        for path, t in _tree(tree):
            jt, cut = _ref(cfg, jtree, path)
            ax = dict(_tree(axes))[path]
            jax_, _ = _ref(cfg, jaxes, path)
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(jt.shape)[cut:], path
            assert str(t.dtype).split(".")[1] == jnp.dtype(jt.dtype).name, path
            assert tuple(ax) == tuple(jax_)[cut:], path
            assert not cut or jax_[0] == "layers"
            n += 1
        return n
    n = same(m.param_shapes(), jm.param_shapes(), m.param_logical_axes(),
             jm.param_logical_axes())
    for name in japplicable(jcfg):
        sh, jsh = SHAPES[name], JSHAPES[name]
        specs, axes = m.input_specs(sh)
        jspecs, jaxes = jm.input_specs(jsh)
        assert set(specs) == set(jspecs)
        n += same(specs, jspecs, axes, jaxes)
        if sh.kind == "decode":
            n += same(m.cache_shapes(sh.global_batch, sh.seq_len),
                      jm.cache_shapes(jsh.global_batch, jsh.seq_len),
                      m.cache_logical_axes(), jm.cache_logical_axes())
        assert dryrun.model_flops(cfg, sh) == jdryrun.model_flops(jcfg, jsh)
    assert n > 10


REF_PROG = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[1])
    import jax
    from jax.sharding import AxisType
    from repro.launch.dryrun import build_cell
    from repro.launch.hlo_analysis import analyze_hlo_text
    from repro.sharding import use_rules
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for cell in sys.argv[2:]:
        arch, shape, scan = cell.split(":")
        os.environ["REPRO_KERNELS"] = scan
        with use_rules(mesh, "baseline"):
            _, _, jitted, args, _ = build_cell(arch, shape, mesh, "baseline",
                                               None, smoke=True)
            txt = jitted.lower(*args).compile().as_text()
        out[cell] = analyze_hlo_text(txt, default_group=2).flops
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_flops():
    out = subprocess.run(
        [sys.executable, "-c", REF_PROG, SRC] + [":".join(c) for c in CELLS],
        capture_output=True, text=True, timeout=600)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, out.stdout + out.stderr[-3000:]
    return json.loads(line[0][len("RESULT "):])


@pytest.mark.parametrize("arch,shape,scan", CELLS)
def test_small_mesh_flops_match_reference(arch, shape, scan,
                                          reference_flops):
    rec = dryrun.run_cell(arch, shape, "debug", "baseline", smoke=True,
                          scan_impl=scan)
    assert rec["ok"], rec.get("traceback")
    assert rec["chips"] == 8 and rec["microbatches"] == \
        dryrun.DEFAULT_MICROBATCHES[SHAPES[shape].kind]
    got = rec["hlo"]["flops_per_device"]
    want = reference_flops[f"{arch}:{shape}:{scan}"]
    assert abs(got / want - 1) < 0.05, (got, want)
    r = rec["roofline"]
    assert r["bound_step_time_s"] == max(r["compute_s"], r["memory_s"],
                                         r["collective_s"]) > 0
    assert rec["memory"]["per_device_bytes"] > rec["memory"]["argument_bytes"]


# ------------------------------------------------------------ cost model
def test_cost_model_known_costs():
    M, N, K, L = 64, 96, 32, 5
    meta = lambda *s: torch.empty(s, device="meta")
    with counting() as t:
        meta(M, K) @ meta(K, N)
    assert abs(t.flops - 2 * M * N * K) / (2 * M * N * K) < 0.02
    with counting() as t:
        c = meta(M, M)
        for w in meta(L, M, M):
            c = c @ w
    exp = 2 * M * M * M * L
    assert abs(t.flops - exp) / exp < 0.02, "loop of L products"


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_cost_model_collective_bytes(n):
    """An all-gather, a reduce-scatter and an all-reduce over a group of
    ``n`` ranks: payload (the output's bytes) times the ring factor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = make_mesh((n,), ("model",))
    rows = 16 * n
    mk = lambda pl, shape: DTensor.from_local(
        torch.empty(shape, device="meta"), mesh, [pl], run_check=False)
    cases = [("all-gather", mk(Shard(0), (16, 64)), Replicate(), rows * 64),
             ("reduce-scatter", mk(Partial(), (rows, 64)), Shard(0), 16 * 64),
             ("all-reduce", mk(Partial(), (rows, 64)), Replicate(),
              rows * 64)]
    for kind, x, to, out_elems in cases:
        with counting() as t:
            x.redistribute(mesh, [to])
        payload = 4 * out_elems
        assert dict(t.collective_count) == {kind: 1}, kind
        assert t.collective_bytes[kind] == payload
        assert t.collective_link_bytes[kind] == \
            payload * _collective_link_factor(kind, n)


def test_cost_model_counts_an_all_to_all():
    from torch.distributed.tensor import DTensor, Shard
    mesh = make_mesh((4,), ("model",))
    x = DTensor.from_local(torch.empty(8, 64, device="meta"), mesh,
                           [Shard(0)], run_check=False)
    with counting() as t:
        x.redistribute(mesh, [Shard(1)])
    assert dict(t.collective_count) == {"all-to-all": 1}
    assert t.collective_link_bytes["all-to-all"] == 32 * 16 * 4 * 3 / 4


# ------------------------------------------------------------- the stub
def test_scan_stub_counts_the_streamed_bytes():
    bt, length, di, s = 3, 40, 24, 8
    m = lambda *shape, dt=torch.bfloat16: torch.empty(shape, dtype=dt,
                                                      device="meta")
    u, d, B, C = m(bt, length, di), m(bt, length, di), m(bt, length, s), \
        m(bt, length, s)
    A, D = m(di, s, dt=torch.float32), m(di, dt=torch.float32)
    with ops.scan_trace("stub"), counting() as t:
        y, h = ops.selective_scan(u, d, A, B, C, D)
    streamed = 2 * (2 * bt * length * di + 2 * bt * length * s) \
        + 4 * bt * length * di + 4 * bt * di * s
    assert t.bytes == streamed and t.flops == 0
    assert (y.shape, h.shape) == ((bt, length, di), (bt, di, s))
    with ops.scan_trace("ref"), counting() as r:
        ops.selective_scan(u, d, A, B, C, D)
    assert r.flops > 0 and r.bytes > t.bytes     # the plain loop's traffic


def test_scan_stub_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 8)
    bc = torch.zeros(1, 4, 2)
    for mode in ("stub", "ref"):
        with ops.scan_trace(mode), pytest.raises(ValueError,
                                                 match="meta tensors"):
            ops.selective_scan(x, x, torch.zeros(8, 2), bc, bc,
                               torch.zeros(8))
    with pytest.raises(ValueError):
        with ops.scan_trace("interpret"):
            pass


# ------------------------------------------------- hillclimb and sweep
def test_hillclimb_and_sweep_knobs_equal_reference():
    jhill, jsweep = _reference("hillclimb"), _reference("optimize_sweep")
    key = lambda it: (it["cell"], it["arch"], it["shape"], it["tag"],
                      it["knobs"])
    assert [key(i) for i in hillclimb.ITERATIONS] == \
        [key(i) for i in jhill.ITERATIONS]
    assert optimize_sweep.BIG == jsweep.BIG
    for arch in ARCH_IDS:
        for shape in japplicable(jget(arch)):
            assert optimize_sweep.knobs_for(arch, shape) == \
                jsweep.knobs_for(arch, shape), (arch, shape)
    for it in hillclimb.ITERATIONS:         # no TPU figure in the texts
        assert "VMEM" not in it["hypothesis"] and "GiB" not in \
            it["hypothesis"], it["tag"]
