"""The port's sharding rules against the reference's, on the CPU.

* The reference's eight unit tests of ``logical_to_spec`` and the rule
  sets, restated on the port (specs as plain tuples).
* ``logical_to_spec`` equals the reference's ``PartitionSpec`` (as a
  tuple) for every rule set × mesh (16, 16), (2, 16, 16), (4, 2) × every
  logical-axes tuple of every ``ARCH_ID`` at full size: parameters,
  decode cache, AdamW state and ``input_specs``.  The reference stacks
  block leaves along a leading ``"layers"`` axis; the port holds one
  leaf per layer, so its spec is the reference's without that first
  entry.  Exact equality.
* DTensor placements on a 4 × 2 mesh of the fake world give the local
  shapes the spec implies (exact).
* ``shard`` is a no-op without rules and on a plain tensor.
"""
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable_shapes as japplicable
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.sharding.rules import RULE_SETS as JRULES
from repro.sharding.rules import logical_to_spec as jspec
from repro.training import AdamWConfig as JAdamW
from repro.training.optimizer import opt_state_logical_axes as jopt_axes

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import build_model
from repro_torch.sharding import (RULE_SETS, logical_to_spec, shard,
                                  shardings_from_axes, spec_to_placements,
                                  use_rules)
from repro_torch.training import AdamWConfig
from repro_torch.training.optimizer import (named_axes,
                                            opt_state_logical_axes)


class FakeMesh:
    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.zeros(shape)


MESHES = [(("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (4, 2))]


def spec(axes, mesh, rules="baseline", dims=None):
    return logical_to_spec(axes, mesh, RULE_SETS[rules], dims)


# ---------------------------------------------------- the reference's tests
def test_logical_mapping_single_pod():
    mesh = FakeMesh(("data", "model"), (16, 16))
    assert spec(("batch", "seq", "embed_act"), mesh) == ("data", None, None)
    assert spec(("embed", "mlp"), mesh) == ("data", "model")
    assert spec(("vocab", "embed"), mesh) == ("model", "data")


def test_logical_mapping_multi_pod():
    mesh = FakeMesh(("pod", "data", "model"), (2, 16, 16))
    assert spec(("batch", "seq"), mesh) == (("pod", "data"), None)


def test_unknown_mesh_axes_pruned():
    mesh = FakeMesh(("data", "model"), (4, 2))
    assert spec(("batch", "seq"), mesh) == ("data", None)   # no 'pod'


def test_divisibility_pruning():
    mesh = FakeMesh(("data", "model"), (16, 16))
    # kv-head dim 8 not divisible by 16 -> replicated
    s = spec(("layers", "cache_batch", "cache_seq", "cache_heads", None),
             mesh, dims=(28, 128, 32768, 8, 128))
    assert s == (None, "data", "model", None, None)
    # batch 1 -> batch axes dropped; batch 128 divisible by 16
    assert spec(("batch", "seq"), mesh, dims=(1, 4096)) == (None, None)
    assert spec(("batch", "seq"), mesh, dims=(128, 4096)) == ("data", None)


def test_tuple_axes_partial_prune():
    mesh = FakeMesh(("pod", "data", "model"), (2, 16, 16))
    assert spec(("batch",), mesh, dims=(2,)) == ("pod",)   # only 'pod' fits


def test_zero3_rules_fully_data_parallel():
    mesh = FakeMesh(("data", "model"), (16, 16))
    assert spec(("batch", "seq", "embed_act"), mesh, rules="zero3",
                dims=(256, 4096, 2048)) == (("data", "model"), None, None)
    assert spec(("embed", "mlp"), mesh, rules="zero3",
                dims=(2048, 6144)) == ("data", "model")


def test_moe_rules_expert_axes():
    mesh = FakeMesh(("data", "model"), (16, 16))
    assert spec(("experts", "expert_embed", "expert_mlp"), mesh,
                rules="moe_ep", dims=(128, 2048, 768)) == ("model", None, None)
    assert spec(("experts", "expert_embed", "expert_mlp"), mesh,
                rules="moe_ep2d", dims=(128, 5120, 8192)) == \
        ("model", None, "data")


def test_all_rule_sets_have_same_keys():
    keys = {name: set(r) for name, r in RULE_SETS.items()}
    base = keys["baseline"]
    for name, k in keys.items():
        assert k == base, f"rule set {name} key mismatch: {k ^ base}"
    assert RULE_SETS == JRULES


# ---------------------------------------------- every tree of every arch
def _walk(tree, path=()):
    """(path, leaf) of a port tree (dicts and per-layer lists)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def ref_leaf(cfg, tree, path):
    """The reference's leaf for the port's ``path``, and whether it is
    stacked along a leading layer axis."""
    if path[0] == "blocks" and cfg.family != "audio":
        return tree["blocks"][f"L{path[1] % cfg.scan_period}"][path[2]], True
    if path[0] in ("enc_blocks", "dec_blocks"):
        return tree[path[0]][path[2]], True
    if path[0] == "blocks":                # audio cache: k/v/ck/cv stacked
        return tree["blocks"][path[2]], True
    node = tree
    for p in path:
        node = node[p]
    return node, False


def pairs(arch):
    """(what, port axes, port dims, ref axes, ref dims, stacked) of every
    leaf of the full-size model's trees."""
    cfg, jcfg = get_config(arch), jget(arch)
    m, jm = build_model(cfg, "meta"), jbuild(jcfg)
    trees = [("param", m.param_logical_axes(), m.param_shapes(),
              jm.param_logical_axes(), jm.param_shapes())]
    for name in japplicable(jcfg):
        sh = SHAPES[name]
        if sh.kind == "decode":
            trees.append((f"cache {name}", m.cache_logical_axes(),
                          m.cache_shapes(sh.global_batch, sh.seq_len),
                          jm.cache_logical_axes(),
                          jm.cache_shapes(sh.global_batch, sh.seq_len)))
        specs, axes = m.input_specs(sh)
        jspecs, jaxes = jm.input_specs(JSHAPES[name])
        trees.append((f"inputs {name}", axes, specs, jaxes, jspecs))
    out = []
    for what, axes, shapes, jaxes_t, jshapes in trees:
        for path, ax in _walk(axes):
            shp = dict(_walk(shapes))[path]
            jax_, stacked = ref_leaf(cfg, jaxes_t, path)
            jshp, _ = ref_leaf(cfg, jshapes, path)
            out.append((f"{what} {path}", ax, tuple(shp.shape), jax_,
                        tuple(jshp.shape), stacked))
    # AdamW state: keyed by parameter name, sharded like the parameters
    state = opt_state_logical_axes(named_axes(m.param_logical_axes()),
                                   AdamWConfig())
    jstate = jopt_axes(jm.param_logical_axes(), JAdamW())
    assert state.step == jstate.step == ()
    shapes = dict(_walk(m.param_shapes()))
    for path, _ in _walk(m.param_logical_axes()):
        name = ".".join(map(str, path))
        for which, tree, jtree in (("m", state.m, jstate.m),
                                   ("v", state.v, jstate.v)):
            jax_, stacked = ref_leaf(cfg, jtree, path)
            jshp, _ = ref_leaf(cfg, jm.param_shapes(), path)
            out.append((f"adamw {which} {name}", tree[name],
                        tuple(shapes[path].shape), jax_, tuple(jshp.shape),
                        stacked))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference_every_rule_set_and_mesh(arch):
    """Exact: for every leaf, every rule set and every mesh."""
    checked = 0
    for what, ax, dims, jax_, jdims, stacked in pairs(arch):
        if stacked:
            assert jax_[0] == "layers" and tuple(jax_[1:]) == tuple(ax), what
            assert jdims[1:] == dims, what
        else:
            assert tuple(jax_) == tuple(ax) and jdims == dims, what
        for names, shape in MESHES:
            mesh = FakeMesh(names, shape)
            for rules in RULE_SETS:
                got = logical_to_spec(ax, mesh, RULE_SETS[rules], dims)
                want = tuple(jspec(jax_, mesh, JRULES[rules], jdims))
                if stacked:
                    assert want[0] is None, what
                    want = want[1:]
                assert got == want, (what, names, rules)
                checked += 1
    assert checked > 1000


# ------------------------------------------------------ placements
def test_placements_give_the_spec_local_shapes():
    """Every parameter and decode-cache leaf of two smoke models, placed
    on a 4 × 2 mesh of the fake world: each local shard's shape is the
    global shape divided by the mesh axes its spec names (exact)."""
    from repro_torch.launch.dryrun import _place
    mesh = make_debug_mesh(4, 2)
    sizes = {"data": 4, "model": 2}
    checked = 0
    for arch in ("qwen3-moe-30b-a3b", "whisper-medium"):
        m = build_model(get_config(arch, smoke=True), "meta")
        for axes, shapes in ((m.param_logical_axes(), m.param_shapes()),
                             (m.cache_logical_axes(), m.cache_shapes(8, 64))):
            for rules in ("baseline", "zero3", "moe_ep2d"):
                placed = _place(shapes, shardings_from_axes(
                    axes, mesh, rules, shapes), mesh)
                for path, ax in _walk(axes):
                    t = dict(_walk(placed))[path]
                    sp = logical_to_spec(ax, mesh, RULE_SETS[rules],
                                         tuple(t.shape))
                    want = tuple(
                        d // int(np.prod([sizes[a] for a in (
                            (p,) if isinstance(p, str) else (p or ()))]))
                        for d, p in zip(t.shape, sp + (None,) * t.ndim))
                    assert tuple(t.to_local().shape) == want, (arch, path)
                    checked += 1
    assert checked > 100


def test_spec_to_placements_orders_and_refuses():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_debug_mesh(4, 2)
    assert spec_to_placements(("data", None, "model"), mesh) == \
        (Shard(0), Shard(2))
    assert spec_to_placements((None, ("data", "model")), mesh) == \
        (Shard(1), Shard(1))
    assert spec_to_placements((), mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        spec_to_placements((("model", "data"),), mesh)


def test_shard_is_a_no_op_without_rules():
    x = torch.randn(4, 8, 16)
    assert shard(x, "batch", "seq", "embed_act") is x
    mesh = FakeMesh(("data", "model"), (4, 2))
    with use_rules(mesh, "baseline"):        # a plain tensor stays as it is
        assert shard(x, "batch", "seq", "embed_act") is x


def test_use_rules_nests_and_restores():
    from repro_torch.sharding import current_rules
    a, b = FakeMesh(("data",), (2,)), FakeMesh(("data", "model"), (4, 2))
    assert current_rules() == (None, None)
    with use_rules(a, "zero3"):
        with use_rules(b):
            assert current_rules() == (b, RULE_SETS["baseline"])
        assert current_rules() == (a, RULE_SETS["zero3"])
    assert current_rules() == (None, None)
    assert logical_to_spec(("batch",)) == ()
