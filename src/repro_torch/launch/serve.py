"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--device cpu]``.

Continuous batching over a fixed number of decode slots (smoke configs).
Each admitted prompt is prefilled alone (a batched prefill would couple
requests through a MoE layer's capacity drops), with its own patches
(vlm) or frames (audio), and its cache written into its slot's rows, so
the slot starts from a fresh cache (KV rows, ``index``, Mamba ``conv``
and ``ssm`` state, cross-attention rows); the first token comes from
that prefill, the rest from decode steps of all slots together.  The
reference instead runs a decode step of every slot per prompt token and
resets only a reused slot's ``index``; for an audio model that never
runs the encoder.
"""
from __future__ import annotations

import argparse
import random
import time
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..configs import ARCH_IDS, get_config
from ..configs.base import ShapeSpec
from ..models import Model, build_model
from ..serving import Request, RequestBatcher
from ..serving.serve_step import (KV_LEAVES, make_decode_step,
                                  make_prefill_step)
from ..training import make_batch_for

#: encoder frames of each request the launcher sends an audio model
SERVE_FRAMES = 64


@torch.no_grad()
def _fill_slot(cache: Dict, slot: int, one: Dict) -> None:
    """Write a one-prompt prefill cache ``one`` into ``slot`` of ``cache``;
    the slot's KV rows past the prompt are zeroed, and every other leaf
    (Mamba state, cross-attention rows) is written whole."""
    for blk, new in zip(cache["blocks"], one["blocks"]):
        for name, leaf in blk.items():
            row = new[name][0]
            if name in KV_LEAVES:
                leaf[slot].zero_()
                leaf[slot, :row.shape[0]] = row
            else:
                leaf[slot] = row
    cache["index"][slot] = one["index"][0]


def _frames(batcher: RequestBatcher, inputs: Mapping) -> Optional[int]:
    """The frames every request of an audio model brings: the cache's
    cross rows, which decode attends whole (``ValueError`` unless every
    request has frames, all of one length)."""
    reqs = list(batcher.queue) + [r for r in batcher.slots if r is not None]
    rows = {int(inputs[r.id]["frames"].shape[1]) if "frames" in inputs.get(
        r.id, {}) else None for r in reqs}
    if len(rows) > 1 or None in rows:
        raise ValueError(f"an audio model's requests need frames of one "
                         f"length; got {sorted(rows, key=str)}")
    return rows.pop() if rows else None


def serve_requests(model: Model, params, batcher: RequestBatcher,
                   max_seq: int, inputs: Optional[Mapping] = None
                   ) -> Tuple[int, int]:
    """Serve every request of ``batcher`` through its slots: (generated
    tokens, decode steps).  ``inputs`` maps a request id to the extra
    entries of its prefill batch, each with a leading batch axis of 1:
    ``patches`` (vlm) or ``frames`` (audio, required).  A request needs
    ``P + len(prompt) + max_new_tokens - 1 <= max_seq`` cache rows, ``P``
    its patches (``ValueError``)."""
    inputs = inputs or {}
    slots, dev = batcher.n_slots, model.device
    n_frames = _frames(batcher, inputs) if model.cfg.family == "audio" \
        else None
    cache = model.init_cache(slots, max_seq, n_frames=n_frames)
    tokens = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    n_tok = steps = 0
    while not batcher.idle:
        for req in batcher.admit():
            extra = {k: v.to(dev) for k, v in inputs.get(req.id, {}).items()}
            patches = extra["patches"].shape[1] if "patches" in extra else 0
            if patches + len(req.prompt) + req.max_new_tokens - 1 > max_seq:
                raise ValueError(f"request {req.id}: {patches} patches + "
                                 f"{len(req.prompt)} prompt + "
                                 f"{req.max_new_tokens} new tokens exceed "
                                 f"max_seq {max_seq}")
            prompt = torch.tensor([req.prompt], dtype=torch.int32,
                                  device=dev)
            logits, one = prefill(params, {"tokens": prompt, **extra})
            _fill_slot(cache, req.slot, one)
            first = int(torch.argmax(logits[0]))
            tokens[req.slot, 0] = first
            n_tok += 1
            batcher.record_tokens({req.slot: first})
        live = batcher.active_slots
        if not live:
            continue
        free = [s for s in range(slots) if s not in live]
        if free:                 # keep free slots' decode writes in range
            cache["index"][free] = 0
        # One decode step of all slots.  Rows are independent, so each
        # request gets the tokens of its prompt alone, only while no
        # token of the step can be dropped: a MoE layer routes the step's
        # rows as one group, and an expert's capacity
        # (``moe.capacity_for``: at least 4) must hold every row.  With
        # 4 slots it is 4 for every config of the repo; with more slots
        # a row, free slots' rows too, can take another's place.
        tokens, cache = decode(params, tokens, cache)
        out = tokens[:, 0].tolist()
        steps += 1
        n_tok += len(live)
        batcher.record_tokens({s: out[s] for s in live})
    return n_tok, steps


def request_inputs(cfg, prompt_len: int, frames: int, seed: int) -> Dict:
    """A request's patches (vlm) or frames (audio) at ``make_batch_for``'s
    shapes for one row, drawn from a generator seeded with ``seed``; on
    the CPU (the serve loop moves them).  Empty for the other families."""
    if cfg.family not in ("vlm", "audio"):
        return {}
    seq = frames if cfg.family == "audio" \
        else cfg.vision_patches + prompt_len
    batch = make_batch_for(cfg, ShapeSpec("serve", seq, 1, "prefill"), 0,
                           seed=seed, device="cpu")
    return {k: v for k, v in batch.items() if k != "tokens"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    model = build_model(cfg, args.device)
    params = model.init_params(seed=0)

    rb = RequestBatcher(args.slots)
    rng = random.Random(0)
    for i in range(args.requests):
        rb.submit(Request(id=f"r{i}",
                          prompt=[rng.randint(2, cfg.vocab_size - 1)
                                  for _ in range(rng.randint(4, 10))],
                          max_new_tokens=rng.randint(8, 16)))
    inputs = {r.id: request_inputs(cfg, len(r.prompt), SERVE_FRAMES, i)
              for i, r in enumerate(rb.queue)}
    t0 = time.time()
    n_tok, _steps = serve_requests(model, params, rb, args.max_seq, inputs)
    dt = time.time() - t0
    print(f"arch={cfg.name}: {len(rb.completed)} requests, {n_tok} tokens, "
          f"{n_tok/dt:.0f} tok/s")


if __name__ == "__main__":
    main()
