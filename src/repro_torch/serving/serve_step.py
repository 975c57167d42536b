"""Serving steps: prefill (prompt -> cache + first logits) and decode
(one token against the cache), and greedy generation on top of them.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models import Model


def make_prefill_step(model: Model) -> Callable:
    def prefill(params, batch) -> Tuple[torch.Tensor, Dict]:
        logits, cache = model.apply(params, batch, mode="prefill")
        return logits[:, -1, :], cache
    return prefill


def make_decode_step(model: Model) -> Callable:
    """One greedy decode step: (next token int32[B, 1], cache)."""
    def decode(params, tokens, cache) -> Tuple[torch.Tensor, Dict]:
        logits, cache = model.apply(params, {"tokens": tokens},
                                    mode="decode", cache=cache)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache
    return decode


def greedy_generate(model: Model, params, batch,
                    max_new_tokens: int) -> torch.Tensor:
    """Prefill + greedy decode loop: int32[B, max_new_tokens].

    One prefill gives both the cache and the first token (the reference
    runs it twice; the results are equal).  The cache is not padded: a
    Mamba cache does not grow with the sequence, whatever the prompt
    length.
    """
    first_logits, cache = make_prefill_step(model)(params, batch)
    tok = torch.argmax(first_logits, dim=-1).to(torch.int32)[:, None]
    decode = make_decode_step(model)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
    return torch.cat(out, dim=1)
