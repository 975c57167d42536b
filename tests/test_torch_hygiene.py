"""The port stands alone and never hides the device.

* Import hygiene: no module of ``src/repro_torch``, ``examples_torch``
  or ``benchmarks_torch`` and not ``chip_smoke.py`` imports ``jax``,
  the reference package ``repro`` or the reference's ``benchmarks``
  (checked on the source with ``ast``, then on ``sys.modules`` after
  importing every port module in a fresh interpreter).
* No fallback: without a GPU, the default device of a vectorized
  dispatcher raises instead of running on the CPU, and so does a CUDA
  device asked for explicitly.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         sorted((ROOT / "examples_torch").glob("*.py")) +
                         sorted((ROOT / "benchmarks_torch").glob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_reference():
    mods = _port_modules()
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert len(mods) >= 20


def test_without_gpu_the_vectorized_path_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core.dispatchers import FirstInFirstOut
    from repro_torch.core.dispatchers.vectorized import (
        VectorizedAllocator, VectorizedEasyBackfilling)
    from repro_torch.kernels import ops
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FirstInFirstOut(VectorizedAllocator("FF"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorizedEasyBackfilling(VectorizedAllocator("BF", batched=False))
    a = np.ones((4, 2), np.int64)
    with pytest.raises((RuntimeError, AssertionError)):
        ops.alloc_score_batch(a, a, np.zeros((1, 2), np.int64), "cuda")
