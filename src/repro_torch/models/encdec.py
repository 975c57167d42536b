"""Whisper-style encoder-decoder (audio family).

The conv frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings ``frames [B, F, d]`` (what the two conv
layers would produce).  Sinusoidal absolute positions on both sides.

Decode: the self-attention cache holds ``max_seq`` rows; the
cross-attention K/V (``ck``/``cv``) are computed from the encoder output
at prefill and read from the cache in decode.

As in ``transformer.py``, the port holds one block per layer in an
``nn.ModuleList`` (the reference stacks them for ``lax.scan``) and
remats per layer through ``torch.utils.checkpoint``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..sharding import shard, splittable, weight_for
from .layers import attention, lookup, mlp, rms_norm
from .transformer import MODES, REMATS, _remat, write_rows


def sinusoid(length: int, d: int, dtype: torch.dtype, device
             ) -> torch.Tensor:
    """[length, d] table of sines then cosines, computed in float32 and
    cast to ``dtype``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------- params
def _attn_specs(cfg: ModelConfig, prefix: str = "") -> Dict[str, Tuple]:
    d, hd, h, kvh = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {
        prefix + "wq": ((d, h * hd), ("embed", "heads"), 0),
        prefix + "wk": ((d, kvh * hd), ("embed", "kv_heads"), 0),
        prefix + "wv": ((d, kvh * hd), ("embed", "kv_heads"), 0),
        prefix + "wo": ((h * hd, d), ("heads", "embed"), 0),
    }


def _ffn_specs(cfg: ModelConfig) -> Dict[str, Tuple]:
    d, f = cfg.d_model, cfg.d_ff
    s = {"w_in": ((d, f), ("embed", "mlp"), 0),
         "w_out": ((f, d), ("mlp", "embed"), 0)}
    if cfg.gated_ffn:
        s["w_gate"] = ((d, f), ("embed", "mlp"), 0)
    return s


def _enc_block_specs(cfg: ModelConfig) -> Dict[str, Tuple]:
    d = cfg.d_model
    specs = {"ln1": ((d,), ("embed_act",), None),
             "ln2": ((d,), ("embed_act",), None)}
    specs.update(_attn_specs(cfg))
    specs.update(_ffn_specs(cfg))
    return specs


def _dec_block_specs(cfg: ModelConfig) -> Dict[str, Tuple]:
    d = cfg.d_model
    specs = {"ln1": ((d,), ("embed_act",), None),
             "ln_cross": ((d,), ("embed_act",), None),
             "ln2": ((d,), ("embed_act",), None)}
    specs.update(_attn_specs(cfg))
    specs.update(_attn_specs(cfg, prefix="c_"))
    specs.update(_ffn_specs(cfg))
    return specs


def param_specs(cfg: ModelConfig) -> Dict:
    """Spec tree of (shape, logical_axes, fan_in_axis), with one entry of
    ``enc_blocks`` and ``dec_blocks`` per layer."""
    d, v = cfg.d_model, cfg.vocab_size
    tree: Dict = {
        "embed": ((v, d), ("vocab", "embed"), 1),
        "enc_blocks": [_enc_block_specs(cfg)
                       for _ in range(cfg.encoder_layers)],
        "dec_blocks": [_dec_block_specs(cfg) for _ in range(cfg.n_layers)],
        "enc_final_norm": ((d,), ("embed_act",), None),
        "final_norm": ((d,), ("embed_act",), None),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((d, v), ("embed", "vocab"), 0)
    return tree


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, n_frames: int,
               dtype: torch.dtype, device) -> Dict:
    """Per-layer cache: ``max_seq`` self-attention rows and ``n_frames``
    cross-attention rows, in the model's type (the reference's, which
    takes no int8 KV here); ``index`` is the fill pointer."""
    kv = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    cross = (batch, n_frames, cfg.n_kv_heads, cfg.hd)
    zeros = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
    return {"blocks": [{"k": zeros(kv), "v": zeros(kv), "ck": zeros(cross),
                        "cv": zeros(cross)} for _ in range(cfg.n_layers)],
            "index": torch.zeros((batch,), dtype=torch.int32,
                                 device=device)}


def cache_logical_axes(cfg: ModelConfig) -> Dict:
    """The cache's logical axes, one entry of ``blocks`` per layer."""
    ax = ("cache_batch", "cache_seq", "cache_heads", None)
    return {"blocks": [{"k": ax, "v": ax, "ck": ax, "cv": ax}
                       for _ in range(cfg.n_layers)],
            "index": ("cache_batch",)}


# ---------------------------------------------------------------- blocks
class _Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor]
                 ) -> None:
        super().__init__()
        self.cfg = cfg
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(t))

    def _proj(self, x, w, heads):
        b, s, _ = x.shape
        return splittable(x @ weight_for(x, w), -1, heads).reshape(
            b, s, heads, self.cfg.hd)

    def _out(self, o, w):
        b, s = o.shape[:2]
        o = splittable(o.reshape(b, s, -1), -1, o.shape[2])
        return o @ weight_for(o, w)

    def _ffn(self, h):
        cfg = self.cfg
        x = rms_norm(h, self.ln2, cfg.norm_eps)
        return h + mlp(x, self.w_in, getattr(self, "w_gate", None),
                       self.w_out, cfg.gated_ffn)


class EncBlock(_Layer):
    """``h + attn(rms_norm(h))`` over all frames (non-causal), then
    ``h + mlp(rms_norm(h))``."""

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = h.shape
        x = rms_norm(h, self.ln1, cfg.norm_eps)
        q = self._proj(x, self.wq, cfg.n_heads)
        k = self._proj(x, self.wk, cfg.n_kv_heads)
        v = self._proj(x, self.wv, cfg.n_kv_heads)
        pos = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
        o = attention(q, k, v, pos, pos, causal=False)
        h = self._ffn(h + self._out(o, self.wo))
        return shard(h, "batch", "seq", "embed_act")


class DecBlock(_Layer):
    """Causal self-attention (over the KV cache in decode), then
    cross-attention over the encoder's frames (``ck``/``cv`` from the
    encoder output in train and prefill, from the cache in decode), then
    the MLP."""

    def forward(self, h: torch.Tensor, cache_in: Optional[Dict],
                positions: torch.Tensor, enc_out: Optional[torch.Tensor],
                mode: str) -> Tuple[torch.Tensor, Optional[Dict]]:
        cfg = self.cfg
        b = h.shape[0]
        nh, kvh = cfg.n_heads, cfg.n_kv_heads
        x = rms_norm(h, self.ln1, cfg.norm_eps)
        q = self._proj(x, self.wq, nh)
        k = self._proj(x, self.wk, kvh)
        v = self._proj(x, self.wv, kvh)
        new_cache = None
        if mode == "decode":
            # written in place at ``index``, as transformer.Block does
            kc, vc = cache_in["k"], cache_in["v"]
            idx = positions[:, 0].long()
            write_rows(kc, idx, k[:, 0])
            write_rows(vc, idx, v[:, 0])
            kv_pos = torch.arange(kc.shape[1], dtype=torch.int32,
                                  device=h.device).expand(b, kc.shape[1])
            o = attention(q, kc, vc, positions, kv_pos)
            new_cache = {"k": kc, "v": vc}
        else:
            o = attention(q, k, v, positions, positions)
            if mode == "prefill":
                new_cache = {"k": k, "v": v}
        h = h + self._out(o, self.wo)

        x = rms_norm(h, self.ln_cross, cfg.norm_eps)
        q = self._proj(x, self.c_wq, nh)
        if mode == "decode":
            ck, cv = cache_in["ck"], cache_in["cv"]
        else:
            ck = self._proj(enc_out, self.c_wk, kvh)
            cv = self._proj(enc_out, self.c_wv, kvh)
        if new_cache is not None:
            new_cache.update({"ck": ck, "cv": cv})
        f = ck.shape[1]
        cpos = torch.arange(f, dtype=torch.int32, device=h.device).expand(b, f)
        o = attention(q, ck, cv, positions, cpos, causal=False)
        h = self._ffn(h + self._out(o, self.c_wo))
        return shard(h, "batch", "seq", "embed_act"), new_cache


class EncDec(nn.Module):
    """The encoder-decoder's parameters and forward pass; the call of
    ``transformer.Transformer`` plus ``frames``."""

    def __init__(self, cfg: ModelConfig, params: Dict) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, p)
                                        for p in params["enc_blocks"])
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, p)
                                        for p in params["dec_blocks"])
        self.enc_final_norm = nn.Parameter(params["enc_final_norm"])
        self.final_norm = nn.Parameter(params["final_norm"])
        self.lm_head = nn.Parameter(params["lm_head"]) \
            if "lm_head" in params else None

    def encode(self, frames: torch.Tensor, remat: str = "full"
               ) -> torch.Tensor:
        """frames [B, F, d] -> encoder output [B, F, d] in the model's
        type, the sinusoid added in that type."""
        h = frames.to(self.embed.dtype)
        h = h + sinusoid(h.shape[1], self.cfg.d_model, h.dtype,
                         h.device)[None]
        h = shard(h, "batch", "seq", "embed_act")
        run = _remat(remat) if torch.is_grad_enabled() else None
        for block in self.enc_blocks:
            h = block(h) if run is None else run(block, h)
        return rms_norm(h, self.enc_final_norm, self.cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, *,
                frames: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None, mode: str = "train",
                remat: str = "full"
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """tokens int[B, S] (decoder) and, in train and prefill, frames
        [B, F, d] -> (logits [B, S, V], new_cache or None)."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}, expected one of {MODES}")
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r}, expected one of {REMATS}")
        if mode == "decode" and cache is None:
            raise ValueError("decode needs a cache")
        if mode != "decode" and frames is None:
            raise ValueError(f"{mode} needs frames")
        cfg = self.cfg
        b, s = tokens.shape
        enc_out = None if mode == "decode" else self.encode(frames, remat)
        h = lookup(self.embed, tokens)
        if mode == "decode":
            positions = cache["index"][:, None]
            max_seq = cache["blocks"][0]["k"].shape[1]
            table = sinusoid(max_seq, cfg.d_model, h.dtype, h.device)
            h = h + lookup(table, cache["index"].long())[:, None, :]
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).expand(b, s)
            h = h + sinusoid(s, cfg.d_model, h.dtype, h.device)[None]
        h = shard(h, "batch", "seq", "embed_act")
        caches_in: List = cache["blocks"] if mode == "decode" \
            else [None] * len(self.dec_blocks)
        run = _remat(remat) if torch.is_grad_enabled() else None
        caches_out = []
        for block, cin in zip(self.dec_blocks, caches_in):
            if run is None:
                h, nc = block(h, cin, positions, enc_out, mode)
            else:
                h, nc = run(block, h, cin, positions, enc_out, mode)
            caches_out.append(nc)
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        head = self.embed.t() if self.lm_head is None else self.lm_head
        logits = shard(h @ weight_for(h, head), "batch", "seq", "vocab")

        new_cache = None
        if mode == "prefill":
            new_cache = {"blocks": caches_out,
                         "index": torch.full((b,), s, dtype=torch.int32,
                                             device=tokens.device)}
        elif mode == "decode":
            new_cache = {"blocks": caches_out, "index": cache["index"] + 1}
        return logits, new_cache
