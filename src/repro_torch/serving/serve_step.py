"""Serving steps: prefill (prompt -> cache + first logits) and decode
(one token against a fixed-size cache), and greedy generation on top of
them.  Each runs under ``torch.no_grad()``: the parameters are
trainable, and serving keeps no autograd state.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models import Model
from ..sharding import shard

#: the cache leaves that hold one row per position (attention's KV cache);
#: an encoder-decoder's cross rows (``ck``, ``cv``) hold one per frame
KV_LEAVES = ("k", "v", "k_scale", "v_scale")


def make_prefill_step(model: Model) -> Callable:
    @torch.no_grad()
    def prefill(params, batch) -> Tuple[torch.Tensor, Dict]:
        logits, cache = model.apply(params, batch, mode="prefill")
        return logits[:, -1, :], cache
    return prefill


def make_decode_step(model: Model) -> Callable:
    """One greedy decode step: (next token int32[B, 1], cache).  Under
    the dry-run's sharding rules the last logits are gathered along the
    vocabulary before the argmax (a no-op everywhere else)."""
    @torch.no_grad()
    def decode(params, tokens, cache) -> Tuple[torch.Tensor, Dict]:
        logits, cache = model.apply(params, {"tokens": tokens},
                                    mode="decode", cache=cache)
        last = shard(logits[:, -1, :], "batch", None)
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        return nxt[:, None], cache
    return decode


def pad_kv(cache: Dict, max_seq: int) -> Dict:
    """The cache with its KV leaves padded with zeros to ``max_seq`` rows;
    Mamba leaves (``conv``, ``ssm``) do not grow, and cross-attention
    leaves (``ck``, ``cv``) are attended whole: both stay as they are."""
    def pad(name, leaf):
        if name not in KV_LEAVES:
            return leaf
        if leaf.shape[1] > max_seq:
            raise ValueError(f"{leaf.shape[1]} cache rows exceed max_seq "
                             f"{max_seq}")
        return F.pad(leaf, (0, 0, 0, 0, 0, max_seq - leaf.shape[1]))
    return {"blocks": [{k: pad(k, v) for k, v in blk.items()}
                       for blk in cache["blocks"]],
            "index": cache["index"]}


def greedy_generate(model: Model, params, batch, max_new_tokens: int,
                    max_seq: Optional[int] = None) -> torch.Tensor:
    """Prefill + greedy decode loop: int32[B, max_new_tokens].

    ``batch`` is a prefill batch: tokens, with ``patches`` or ``frames``
    where the model takes them.  The KV cache is padded to ``max_seq``
    (default: the prefill's positions, patches included, +
    ``max_new_tokens``), so every decode step has the same shapes.  Only
    the KV leaves are padded: the reference's shape test also pads a
    Mamba ``conv`` cache whenever the prompt has ``conv_width - 1``
    tokens, and an audio ``ck``/``cv`` whenever the frames number the
    prompt's tokens; its default leaves out a vlm prompt's patches.  One
    prefill gives both the cache and the first token (the reference runs
    it twice; the results are equal).
    """
    sp = batch["tokens"].shape[1]
    if "patches" in batch:
        sp += batch["patches"].shape[1]
    max_seq = max_seq or (sp + max_new_tokens)
    first_logits, cache = make_prefill_step(model)(params, batch)
    cache = pad_kv(cache, max_seq)
    tok = torch.argmax(first_logits, dim=-1).to(torch.int32)[:, None]
    decode = make_decode_step(model)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
    return torch.cat(out, dim=1)
