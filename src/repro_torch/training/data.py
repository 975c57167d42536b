"""Deterministic synthetic data pipeline.

Every batch is a pure function of ``(seed, step)``: after a checkpoint
restart the pipeline replays identically (restart-exact training).
Tokens are drawn on the CPU from a ``torch.Generator`` seeded with
``(seed, step)`` and then copied to ``device``, so a run on the card and
a run on the CPU see the same batch.  (The values differ from the
reference's threefry draws; the contract is determinism.)  Two
generators:

* ``synthetic_lm_batch`` — uniform random tokens;
* ``copy_task_batch``   — second half of each sequence repeats the first
  half; a small LM visibly learns it in a few hundred steps.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..kernels.ops import resolve_device


def _generator(seed: int, step) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(
        (int(seed) << 32) + int(step))


def _randint(low, high, shape, seed, step, device) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=_generator(seed, step),
                         dtype=torch.int32).to(resolve_device(device))


def synthetic_lm_batch(cfg: ModelConfig, batch: int, seq: int, step,
                       seed: int = 17, device=None) -> Dict[str, torch.Tensor]:
    return {"tokens": _randint(0, cfg.vocab_size, (batch, seq), seed, step,
                               device)}


def copy_task_batch(cfg: ModelConfig, batch: int, seq: int, step,
                    seed: int = 17, device=None) -> Dict[str, torch.Tensor]:
    half = seq // 2
    first = _randint(2, cfg.vocab_size, (batch, half), seed, step, device)
    toks = torch.cat([first, first], dim=1)
    if toks.shape[1] < seq:
        toks = torch.nn.functional.pad(toks, (0, seq - toks.shape[1]),
                                       value=1)
    return {"tokens": toks}


def make_batch_for(cfg: ModelConfig, shape: ShapeSpec, step, seed: int = 17,
                   task: str = "lm", device=None) -> Dict[str, torch.Tensor]:
    """Family-aware batch construction: tokens for the dense, moe,
    hybrid and ssm families; audio frames and vision patches wait for
    their families."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.family} batches: the port runs the dense, moe, hybrid "
            "and ssm families (ROADMAP queue 1 item 4)")
    gen = copy_task_batch if task == "copy" else synthetic_lm_batch
    return gen(cfg, shape.global_batch, shape.seq_len, step, seed, device)
