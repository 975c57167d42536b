"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--device cpu]``.

Continuous batching over a fixed number of decode slots (smoke configs).
Each admitted prompt is prefilled alone (a batched prefill would couple
requests through a MoE layer's capacity drops) and its cache written
into its slot's rows, so the slot starts from a fresh cache (KV rows,
``index``, Mamba ``conv`` and ``ssm`` state); the first token comes from
that prefill, the rest from decode steps of all slots together.  The
reference instead runs a decode step of every slot per prompt token and
resets only a reused slot's ``index``.
"""
from __future__ import annotations

import argparse
import random
import time
from typing import Dict, Tuple

import torch

from ..configs import ARCH_IDS, get_config
from ..models import Model, build_model
from ..serving import Request, RequestBatcher
from ..serving.serve_step import (KV_LEAVES, make_decode_step,
                                  make_prefill_step)


@torch.no_grad()
def _fill_slot(cache: Dict, slot: int, one: Dict) -> None:
    """Write a one-prompt prefill cache ``one`` into ``slot`` of ``cache``;
    the slot's KV rows past the prompt are zeroed."""
    for blk, new in zip(cache["blocks"], one["blocks"]):
        for name, leaf in blk.items():
            row = new[name][0]
            if name in KV_LEAVES:
                leaf[slot].zero_()
                leaf[slot, :row.shape[0]] = row
            else:
                leaf[slot] = row
    cache["index"][slot] = one["index"][0]


def serve_requests(model: Model, params, batcher: RequestBatcher,
                   max_seq: int) -> Tuple[int, int]:
    """Serve every request of ``batcher`` through its slots: (generated
    tokens, decode steps).  A request needs ``len(prompt) +
    max_new_tokens - 1 <= max_seq`` cache rows (``ValueError``)."""
    slots, dev = batcher.n_slots, model.device
    cache = model.init_cache(slots, max_seq)
    tokens = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    n_tok = steps = 0
    while not batcher.idle:
        for req in batcher.admit():
            if len(req.prompt) + req.max_new_tokens - 1 > max_seq:
                raise ValueError(f"request {req.id}: {len(req.prompt)} "
                                 f"prompt + {req.max_new_tokens} new tokens "
                                 f"exceed max_seq {max_seq}")
            prompt = torch.tensor([req.prompt], dtype=torch.int32,
                                  device=dev)
            logits, one = prefill(params, {"tokens": prompt})
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
    t0 = time.time()
    n_tok, _steps = serve_requests(model, params, rb, args.max_seq)
    dt = time.time() - t0
    print(f"arch={cfg.name}: {len(rb.completed)} requests, {n_tok} tokens, "
          f"{n_tok/dt:.0f} tok/s")


if __name__ == "__main__":
    main()
