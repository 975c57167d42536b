"""Deterministic synthetic data pipeline.

Every batch is a pure function of ``(seed, step)``: after a checkpoint
restart the pipeline replays identically (restart-exact training).
Tokens are drawn on the CPU from a ``torch.Generator`` seeded with
``(seed, step)`` and then copied to ``device``, so a run on the card and
a run on the CPU see the same batch; so are the audio frames and
vision patches of ``make_batch_for``.  (The values differ from the
reference's threefry draws; the contract is determinism.)  Two
generators:

* ``synthetic_lm_batch`` — uniform random tokens;
* ``copy_task_batch``   — second half of each sequence repeats the first
  half; a small LM visibly learns it in a few hundred steps.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..kernels.ops import resolve_device


def _generator(seed: int, step) -> torch.Generator:
    """A CPU generator keyed on both ``seed`` and ``step``: the CPU's
    Mersenne Twister keeps 32 bits of its seed, so the pair is mixed
    into 32 bits (``(seed << 32) + step`` would drop the seed)."""
    key = np.random.SeedSequence((int(seed), int(step))).generate_state(1)
    return torch.Generator(device="cpu").manual_seed(int(key[0]))


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


def embeddings(cfg: ModelConfig, batch: int, rows: int, step, seed: int,
               device=None) -> torch.Tensor:
    """Precomputed frontend embeddings (audio frames, vision patches),
    [batch, rows, d_model]: normal draws in float32 from a generator
    seeded with ``(seed, step)``, cast to the model's type."""
    x = torch.randn((batch, rows, cfg.d_model), generator=_generator(
        seed, step), dtype=torch.float32)
    return x.to(getattr(torch, cfg.dtype)).to(resolve_device(device))


def make_batch_for(cfg: ModelConfig, shape: ShapeSpec, step, seed: int = 17,
                   task: str = "lm", device=None) -> Dict[str, torch.Tensor]:
    """Family-aware batch construction: audio gets ``frames [b, s, d]``
    and decoder tokens ``[b, max(s // 8, 8)]``; vlm gets tokens ``[b, s -
    P]`` and ``patches [b, P, d]``; the rest tokens ``[b, s]``.  The
    embeddings are drawn with ``(seed + 1, step)``."""
    gen = copy_task_batch if task == "copy" else synthetic_lm_batch
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return {"frames": embeddings(cfg, b, s, step, seed + 1, device),
                "tokens": gen(cfg, b, max(s // 8, 8), step, seed,
                              device)["tokens"]}
    if cfg.family == "vlm":
        p = cfg.vision_patches
        return {"tokens": gen(cfg, b, s - p, step, seed, device)["tokens"],
                "patches": embeddings(cfg, b, p, step, seed + 1, device)}
    return gen(cfg, b, s, step, seed, device)
