"""The port's launchers and LM examples on the CPU.

* ``launch/serve.py``'s loop gives each request the tokens of
  ``greedy_generate`` on its prompt alone, through reused slots, for a
  dense, a Mamba, a MoE and a hybrid model (a reused Mamba slot starts
  from a fresh ``conv``/``ssm`` state; a reused KV slot from zeroed
  rows; with 3 slots a MoE decode step drops no token);
* ``python -m repro_torch.launch.{serve,train}`` print the reference's
  lines (the train launcher's lr values equal the reference's schedule;
  ``--resume`` continues from the last checkpoint), for the moe and
  hybrid smoke configs too;
* ``examples_torch/train_lm.py`` at 2 steps writes the reference's
  ``log.json`` fields and lines; ``examples_torch/serve_lm.py`` serves
  the reference example's requests (same ids, prompts, token counts)
  and prints its lines.
"""
import importlib.util
import json
import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.training import AdamWConfig as JAdamW
from repro.training import cosine_lr as jcosine_lr

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.serving import Request, RequestBatcher, greedy_generate

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(folder, name):
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(mod, argv, cwd, monkeypatch, capsys):
    """``mod.main()`` with ``argv`` in ``cwd``: its standard output."""
    cwd.mkdir(exist_ok=True)
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [str(mod.__file__)] + argv)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("arch", ["smollm-360m", "falcon-mamba-7b",
                                  "qwen3-moe-30b-a3b", "jamba-1.5-large-398b"])
def test_serve_loop_gives_each_request_its_greedy_tokens(arch):
    """7 requests of 1-9 prompt tokens through 3 slots (slots are reused;
    one request of a single new token frees its slot at admission):
    every request's tokens equal ``greedy_generate`` on its prompt alone,
    and each prompt is prefilled once (one scan per Mamba layer)."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init_params(seed=0)
    rng = np.random.default_rng(7)
    rb = RequestBatcher(3)
    lengths = (5, 1, 9, 3, 7, 2, 4)
    news = (6, 4, 1, 8, 5, 7, 3)
    for i, (n, k) in enumerate(zip(lengths, news)):
        rb.submit(Request(id=f"r{i}", max_new_tokens=k, prompt=rng.integers(
            2, cfg.vocab_size, n).tolist()))
    before = ops.launch_stats().get("selective_scan", 0)
    n_tok, steps = launch_serve.serve_requests(model, params, rb, max_seq=16)
    scans = ops.launch_stats().get("selective_scan", 0) - before
    assert n_tok == sum(news) and len(rb.completed) == len(lengths)
    assert steps < sum(news)
    assert scans == len(lengths) * sum(cfg.layer_kind(i) == "mamba"
                                       for i in range(cfg.n_layers))
    for req in rb.completed:
        want = greedy_generate(model, params, {"tokens": torch.tensor(
            [req.prompt], dtype=torch.int32)}, req.max_new_tokens,
            max_seq=16)
        assert req.generated == want[0].tolist(), req.id


def test_serve_loop_refuses_a_request_past_max_seq():
    model = build_model(get_config("smollm-360m", smoke=True), "cpu")
    rb = RequestBatcher(2)
    rb.submit(Request(id="long", prompt=[3] * 10, max_new_tokens=8))
    with pytest.raises(ValueError, match="exceed max_seq 16"):
        launch_serve.serve_requests(model, model.init_params(seed=0), rb, 16)


def test_serve_main_prints_reference_line(capsys):
    """The reference's last line; its 8 requests ask for 97 tokens (the
    reference's own run prints 97 as well)."""
    launch_serve.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    m = re.fullmatch(r"arch=smollm-360m-smoke: 8 requests, (\d+) tokens, "
                     r"\d+ tok/s", out[0])
    assert m and int(m.group(1)) == 97


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b"])
def test_serve_main_moe_and_hybrid(arch, capsys):
    """The serve launcher on a MoE and a hybrid smoke config: the
    reference's line, and the 97 tokens its 8 requests ask for."""
    launch_serve.main(["--arch", arch, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    name = re.escape(get_config(arch, smoke=True).name)
    m = re.fullmatch(rf"arch={name}: 8 requests, (\d+) tokens, \d+ tok/s",
                     out[-1])
    assert len(out) == 1 and m and int(m.group(1)) == 97


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b"])
def test_train_main_moe_and_hybrid(arch, tmp_path, capsys):
    """The train launcher on a MoE and a hybrid smoke config for 2 steps
    of batch 2 x 32: the reference's first line (its parameter count),
    finite step lines in its format, and the final checkpoint."""
    ck = str(tmp_path / "ck")
    launch_train.main(["--arch", arch, "--steps", "2", "--batch", "2",
                       "--seq", "32", "--ckpt-dir", ck, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    jcfg = jget(arch, smoke=True)
    assert out[0] == (f"arch={jcfg.name} params={jcfg.param_count()/1e6:.1f}M"
                      " batch=2 seq=32")
    for i, line in zip((0, 1), out[1:3]):
        m = re.fullmatch(rf"step {i:4d} loss (\d+\.\d{{4}}) lr \S+", line)
        assert m and np.isfinite(float(m.group(1))), line
    assert re.fullmatch(rf"done in \d+\.\ds; checkpoints in {ck}", out[3])
    assert (tmp_path / "ck" / "step_2" / "manifest.json").exists()


def test_train_main_prints_reference_lines_and_resumes(tmp_path, capsys):
    """Two steps, then ``--resume`` to four: the reference's lines, its
    schedule's lr values, and a restart from the saved step."""
    ck = str(tmp_path / "ck")
    launch_train.main(["--arch", "smollm-360m", "--steps", "2",
                       "--ckpt-dir", ck, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "arch=smollm-360m-smoke params=0.2M batch=4 seq=128"
    jcfg = JAdamW(lr=3e-4, warmup_steps=0, total_steps=2)
    for i, line in zip((0, 1), out[1:3]):
        m = re.fullmatch(rf"step {i:4d} loss (\d+\.\d{{4}}) lr (\S+)", line)
        assert m, line
        assert m.group(2) == f"{float(jcosine_lr(jcfg, jnp.int32(i + 1))):.2e}"
    assert re.fullmatch(rf"done in \d+\.\ds; checkpoints in {ck}", out[3])
    assert len(out) == 4

    launch_train.main(["--arch", "smollm-360m", "--steps", "4",
                       "--ckpt-dir", ck, "--device", "cpu", "--resume"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[1] == "resumed from step 2"
    assert re.fullmatch(r"step    3 loss \d+\.\d{4} lr \S+", out[2])
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_2", "step_4"]


def test_train_lm_example_writes_reference_log(tmp_path, monkeypatch,
                                               capsys):
    """Two steps of the example's 93.6M-parameter model: its lines, and
    ``log.json`` with the reference's fields, the lr of the reference's
    schedule, and finite, falling losses from near ln(2048)."""
    out = _run(_load("examples_torch", "train_lm"), ["2", "--device", "cpu"],
               tmp_path, monkeypatch, capsys).strip().splitlines()
    assert out[0] == "model: smollm-100m  params=93.6M"
    for i, line in zip((0, 1), out[1:3]):
        assert re.fullmatch(rf"step {i:4d}  loss \d+\.\d{{4}}  gnorm "
                            r"\d+\.\d\d  [\d,]+ tok/s", line), line
    assert re.fullmatch(r"loss: \d+\.\d{3} -> \d+\.\d{3} \((LEARNED|"
                        r"improving)\)", out[3])
    log = json.loads((tmp_path / "results/train_lm/log.json").read_text())
    jcfg = JAdamW(lr=1.5e-3, warmup_steps=40, total_steps=2)
    assert [list(e) for e in log] == [["step", "loss", "lr", "elapsed_s"]] * 2
    assert [e["step"] for e in log] == [0, 1]
    assert [e["lr"] for e in log] == [float(jcosine_lr(jcfg, jnp.int32(i)))
                                      for i in (1, 2)]
    assert abs(log[0]["loss"] - np.log(2048)) < 1.0
    assert (tmp_path / "results/train_lm/ckpt/step_2/manifest.json").exists()


def test_serve_lm_example_serves_reference_requests(tmp_path, monkeypatch,
                                                    capsys):
    """The reference example's 3 requests (ids, prompts and the 51 tokens
    they ask for, as the reference's own run prints) and its lines."""
    out = _run(_load("examples_torch", "serve_lm"), ["3", "--device", "cpu"],
               tmp_path, monkeypatch, capsys).strip().splitlines()
    m = re.fullmatch(r"served 3 requests, (\d+) tokens in \d+\.\ds "
                     r"\(\d+ tok/s, (\d+) batch steps\)", out[0])
    assert m and int(m.group(1)) == 51
    assert len(out) == 4
    prompts = {"req0": [196, 229, 109, 12], "req1": [93, 151, 230, 234],
               "req2": [253, 182, 209, 156]}
    for line in out[1:]:
        m = re.fullmatch(r"  (req\d): prompt=(\[.*\])\.\.\. -> (\[.*\])\.\.\.",
                         line)
        assert m, line
        assert json.loads(m.group(2)) == prompts[m.group(1)]
        assert len(json.loads(m.group(3))) == 8
