"""Decoder-only LM covering the dense family (attention + dense FFN,
GQA/MQA, optional qk-norm), the moe family (routed-expert FFNs on every
layer or every other one, with an optional shared expert), the vlm
family (a dense decoder with early-fused patch embeddings), the hybrid
family (Jamba: Mamba and attention layers in one stack, periodic MoE)
and the attention-free ssm family (a stack of Mamba-1 blocks).

Where the reference stacks layers per scan period and iterates them with
``lax.scan``, the port holds one :class:`Block` per layer in an
``nn.ModuleList`` and loops over them in Python.  The reference's
``shard`` annotations stand at its places; they act only under the
dry-run's sharding rules, on DTensors.  Its remat policies map to
``torch.utils.checkpoint`` per layer.  Three modes share one code path:

  train    — full-sequence causal forward, no cache;
  prefill  — train-like forward that also emits a KV/SSM cache;
  decode   — single-token step against a fixed-size cache.

The audio family (an encoder-decoder) is ``encdec.py``.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from ..sharding import local_shard, shard, splittable, weight_for
from .layers import attention, lookup, mlp, rms_norm, rope
from .mamba import MambaCache, mamba_mixer
from .moe import MoEParams, moe_ffn

MODES = ("train", "prefill", "decode")
REMATS = ("full", "dots", "none")
FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a decoder-only family.  As in the
    reference, any of them takes patch embeddings, and ``encoder_layers``
    outside the audio family builds no encoder."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                         f"decoder-only one {FAMILIES}")


# ----------------------------------------------------------------------
# Parameter specification: leaf name -> (shape, logical axes, fan_in axis)
# ----------------------------------------------------------------------

def _sublayer_specs(cfg: ModelConfig, i: int) -> Dict[str, Tuple]:
    d, hd, h, kvh = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    specs: Dict[str, Tuple] = {"ln1": ((d,), ("embed_act",), None)}
    if cfg.layer_kind(i) == "attn":
        specs.update({
            "wq": ((d, h * hd), ("embed", "heads"), 0),
            "wk": ((d, kvh * hd), ("embed", "kv_heads"), 0),
            "wv": ((d, kvh * hd), ("embed", "kv_heads"), 0),
            "wo": ((h * hd, d), ("heads", "embed"), 0),
        })
        if cfg.qk_norm:
            specs["q_norm"] = ((hd,), (None,), None)
            specs["k_norm"] = ((hd,), (None,), None)
    else:
        di, s, dtr = cfg.d_inner, cfg.ssm_state, cfg.dtr
        specs.update({
            "in_proj": ((d, 2 * di), ("embed", "inner"), 0),
            "conv_w": ((di, cfg.conv_width), ("inner", None), None),
            "conv_b": ((di,), ("inner",), None),
            "x_proj": ((di, dtr + 2 * s), ("inner", None), 0),
            "dt_proj_w": ((dtr, di), (None, "inner"), 0),
            "dt_proj_b": ((di,), ("inner",), None),
            "A_log": ((di, s), ("inner", "state"), None),
            "D": ((di,), ("inner",), None),
            "out_proj": ((di, d), ("inner", "embed"), 0),
        })
    fk = cfg.ffn_kind(i)
    if fk != "none":
        specs["ln2"] = ((d,), ("embed_act",), None)
    if fk == "dense":
        f = cfg.d_ff
        specs.update({
            "w_in": ((d, f), ("embed", "mlp"), 0),
            "w_out": ((f, d), ("mlp", "embed"), 0),
        })
        if cfg.gated_ffn:
            specs["w_gate"] = ((d, f), ("embed", "mlp"), 0)
    elif fk == "moe":
        e, f = cfg.n_experts, (cfg.moe_d_ff or cfg.d_ff)
        expert = ("experts", "expert_embed", "expert_mlp")
        specs.update({
            "router": ((d, e), ("embed", None), 0),
            "moe_w_in": ((e, d, f), expert, 1),
            "moe_w_out": ((e, f, d),
                          ("experts", "expert_mlp", "expert_embed"), 1),
        })
        if cfg.gated_ffn:
            specs["moe_w_gate"] = ((e, d, f), expert, 1)
        if cfg.shared_expert:
            specs.update({
                "shared_w_in": ((d, cfg.d_ff), ("embed", "mlp"), 0),
                "shared_w_out": ((cfg.d_ff, d), ("mlp", "embed"), 0),
            })
            if cfg.gated_ffn:
                specs["shared_w_gate"] = ((d, cfg.d_ff), ("embed", "mlp"), 0)
    return specs


def param_specs(cfg: ModelConfig) -> Dict:
    """Spec tree of (shape, logical_axes, fan_in_axis), with one entry of
    ``blocks`` per layer."""
    d, v = cfg.d_model, cfg.vocab_size
    tree: Dict = {
        "embed": ((v, d), ("vocab", "embed"), 1),
        "final_norm": ((d,), ("embed_act",), None),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((d, v), ("embed", "vocab"), 0)
    tree["blocks"] = [_sublayer_specs(cfg, i) for i in range(cfg.n_layers)]
    return tree


# ----------------------------------------------------------------------
# Cache
# ----------------------------------------------------------------------

def _quantize_kv(x: torch.Tensor):
    """int8 symmetric quantization over head_dim: x [..., hd] ->
    (int8[..., hd], f32 scale[..., 1]); rounds half to even."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(scale, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def write_rows(cache: torch.Tensor, idx: torch.Tensor,
               val: torch.Tensor) -> None:
    """``cache[b, idx[b]] = val[b]`` for every row ``b``, in place (the
    reference donates the cache).  A DTensor cache keeps its placement:
    ``val`` and ``idx`` are placed like its batch shards, and each device
    writes the rows that fall in its own shard of the sequence axis (an
    in-place write cannot change a DTensor's placement)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(cache, DTensor):
        cache[torch.arange(cache.shape[0], device=cache.device), idx] = val
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, cp = cache.device_mesh, cache.placements
    # val [B, ...] drops the sequence axis of cache [B, S, ...]
    vp = tuple(Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard)
               and p.dim != 1 else Replicate() for p in cp)
    ip = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in cp)
    v, i = local_shard(val, mesh, vp), local_shard(idx, mesh, ip)
    local = cache.to_local()
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, cp)
    n = local.shape[1]
    li = i - offset[1]
    inside = (li >= 0) & (li < n)
    li = li.clamp(0, n - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    keep = inside.reshape((-1,) + (1,) * (v.ndim - 1))
    local[rows, li] = torch.where(keep, v, local[rows, li])


def init_cache(cfg: ModelConfig, batch: int, max_seq: Optional[int],
               dtype: torch.dtype, device) -> Dict:
    """Per-layer cache; ``index`` is the fill pointer.  Attention layers
    hold ``max_seq`` KV rows (required when there are any); a Mamba
    layer's cache does not grow with the sequence."""
    blocks: List[Dict] = []
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "attn":
            if max_seq is None:
                raise ValueError(f"{cfg.name}: an attention cache needs "
                                 "max_seq")
            shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
            if cfg.kv_cache_dtype == "int8":
                blocks.append({
                    "k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(shape[:-1] + (1,),
                                           dtype=torch.float32,
                                           device=device),
                    "v_scale": torch.zeros(shape[:-1] + (1,),
                                           dtype=torch.float32,
                                           device=device)})
            else:
                blocks.append({
                    "k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)})
        else:
            blocks.append({
                "conv": torch.zeros((batch, cfg.conv_width - 1,
                                     cfg.d_inner), dtype=dtype,
                                    device=device),
                "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                                   dtype=torch.float32, device=device)})
    return {"blocks": blocks,
            "index": torch.zeros((batch,), dtype=torch.int32,
                                 device=device)}


def cache_logical_axes(cfg: ModelConfig) -> Dict:
    """The cache's logical axes, one entry of ``blocks`` per layer."""
    blocks: List[Dict] = []
    kv_ax = ("cache_batch", "cache_seq", "cache_heads", None)
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "attn":
            blk = {"k": kv_ax, "v": kv_ax}
            if cfg.kv_cache_dtype == "int8":
                blk["k_scale"] = kv_ax
                blk["v_scale"] = kv_ax
        else:
            blk = {"conv": ("cache_batch", None, "inner"),
                   "ssm": ("cache_batch", "inner", "state")}
        blocks.append(blk)
    return {"blocks": blocks, "index": ("cache_batch",)}


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of matrix products with no
    batch dimension (the reference's ``dots_with_no_batch_dims_saveable``;
    attention's and the experts' batched products are recomputed),
    recompute the rest."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


class Block(nn.Module):
    """One layer: ``h + mixer(rms_norm(h))`` with an attention or Mamba
    mixer, then ``h + ffn(rms_norm(h))`` where the layer has a dense or
    MoE FFN.  Parameters keep the reference's leaf names and layouts."""

    def __init__(self, cfg: ModelConfig, i: int,
                 params: Dict[str, torch.Tensor]) -> None:
        super().__init__()
        self.cfg = cfg
        self.attn = cfg.layer_kind(i) == "attn"
        self.ffn = cfg.ffn_kind(i)
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(t))

    def forward(self, h: torch.Tensor, cache_in: Optional[Dict],
                positions: torch.Tensor, mode: str
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        if self.attn:
            h, nc = self._attention(h, cache_in, positions, mode)
        else:
            h, nc = self._mamba(h, cache_in, mode)
        if self.ffn == "dense":
            x = rms_norm(h, self.ln2, self.cfg.norm_eps)
            w_gate = getattr(self, "w_gate", None)
            h = h + mlp(x, shard(self.w_in, "embed", "mlp"),
                        None if w_gate is None
                        else shard(w_gate, "embed", "mlp"),
                        shard(self.w_out, "mlp", "embed"), self.cfg.gated_ffn)
        elif self.ffn == "moe":
            h = h + self._moe(rms_norm(h, self.ln2, self.cfg.norm_eps))
        return shard(h, "batch", "seq", "embed_act"), nc

    def _moe(self, x):
        """The routed experts (``moe_w_gate`` falls back to ``moe_w_in``
        without a gated FFN, as in the reference) and the shared one."""
        cfg = self.cfg
        exp = lambda w: shard(w, "experts", "expert_embed", "expert_mlp")
        p = MoEParams(
            router=self.router, w_in=exp(self.moe_w_in),
            w_gate=exp(getattr(self, "moe_w_gate", self.moe_w_in)),
            w_out=shard(self.moe_w_out, "experts", "expert_mlp",
                        "expert_embed"),
            shared_w_in=getattr(self, "shared_w_in", None),
            shared_w_gate=getattr(self, "shared_w_gate", None),
            shared_w_out=getattr(self, "shared_w_out", None))
        return moe_ffn(x, p, k=cfg.experts_per_token,
                       n_experts=cfg.n_experts,
                       group_size=cfg.moe_group_size,
                       capacity_factor=cfg.capacity_factor,
                       gated=cfg.gated_ffn)

    def _attention(self, h, cache_in, positions, mode):
        """Decode writes the new token's K/V into ``cache_in`` in place
        at ``index`` (the reference donates the cache) and attends over
        all ``max_seq`` rows under the position mask."""
        cfg = self.cfg
        b, s, _ = h.shape
        hd, nh, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        x = rms_norm(h, self.ln1, cfg.norm_eps)
        wq = shard(self.wq, "embed", "heads")
        wk = shard(self.wk, "embed", "kv_heads")
        wv = shard(self.wv, "embed", "kv_heads")
        q = splittable(x @ weight_for(x, wq), -1, nh).reshape(b, s, nh, hd)
        k = splittable(x @ weight_for(x, wk), -1, kvh).reshape(b, s, kvh,
                                                                 hd)
        v = splittable(x @ weight_for(x, wv), -1, kvh).reshape(b, s, kvh,
                                                                 hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        q = shard(q, "batch", "seq", "heads", None)

        new_cache = None
        quant = cfg.kv_cache_dtype == "int8"
        if mode == "decode":
            kc, vc = cache_in["k"], cache_in["v"]
            idx = positions[:, 0].long()
            if quant:
                kq, ks = _quantize_kv(k[:, 0])
                vq, vs = _quantize_kv(v[:, 0])
                write_rows(kc, idx, kq)
                write_rows(vc, idx, vq)
                kscale, vscale = cache_in["k_scale"], cache_in["v_scale"]
                write_rows(kscale, idx, ks)
                write_rows(vscale, idx, vs)
                k_full = _dequantize_kv(kc, kscale, k.dtype)
                v_full = _dequantize_kv(vc, vscale, v.dtype)
                new_cache = {"k": kc, "v": vc, "k_scale": kscale,
                             "v_scale": vscale}
            else:
                write_rows(kc, idx, k[:, 0])
                write_rows(vc, idx, v[:, 0])
                k_full, v_full = kc, vc
                new_cache = {"k": kc, "v": vc}
            kv_pos = torch.arange(kc.shape[1], dtype=torch.int32,
                                  device=h.device).expand(b, kc.shape[1])
            out = attention(q, k_full, v_full, positions, kv_pos)
        else:
            out = attention(q, k, v, positions, positions)
            if mode == "prefill":
                if quant:
                    kq, ks = _quantize_kv(k)
                    vq, vs = _quantize_kv(v)
                    new_cache = {"k": kq, "v": vq, "k_scale": ks,
                                 "v_scale": vs}
                else:
                    new_cache = {"k": k, "v": v}
        out = splittable(out.reshape(b, s, nh * hd), -1, nh)
        out = out @ weight_for(out, shard(self.wo, "heads", "embed"))
        return h + out, new_cache

    def _mamba(self, h, cache_in, mode):
        cfg = self.cfg
        x = rms_norm(h, self.ln1, cfg.norm_eps)
        cache = None
        if mode == "decode":
            cache = MambaCache(conv=cache_in["conv"], ssm=cache_in["ssm"])
        out, new_cache = mamba_mixer(
            x, self._parameters, ssm_state=cfg.ssm_state,
            conv_width=cfg.conv_width, dt_rank=cfg.dtr, cache=cache,
            return_cache=(mode == "prefill"))
        nc = None
        if new_cache is not None:
            nc = {"conv": new_cache.conv, "ssm": new_cache.ssm}
        return h + out, nc


class Transformer(nn.Module):
    """The LM's parameters and forward pass (``params`` of the reference's
    functional API)."""

    def __init__(self, cfg: ModelConfig, params: Dict) -> None:
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.final_norm = nn.Parameter(params["final_norm"])
        self.lm_head = nn.Parameter(params["lm_head"]) \
            if "lm_head" in params else None
        self.blocks = nn.ModuleList(Block(cfg, i, p)
                                    for i, p in enumerate(params["blocks"]))

    def forward(self, tokens: torch.Tensor, *,
                patches: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None, mode: str = "train",
                remat: str = "full"
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """tokens int[B, S], and optionally patches [B, P, d] early-fused
        before them -> (logits [B, P + S, V], new_cache or None).

        ``remat`` applies where autograd records: ``"full"`` recomputes
        each layer in the backward pass, ``"dots"`` keeps its matrix
        products and recomputes the rest, ``"none"`` keeps everything."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}, expected one of {MODES}")
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r}, expected one of {REMATS}")
        if mode == "decode" and cache is None:
            raise ValueError("decode needs a cache")
        cfg = self.cfg
        b, s = tokens.shape
        h = lookup(self.embed, tokens)
        if patches is not None:
            h = torch.cat([patches.to(h.dtype), h], dim=1)
            s = h.shape[1]
        h = shard(h, "batch", "seq", "embed_act")
        if mode == "decode":
            positions = cache["index"][:, None]
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).expand(b, s)
        caches_in: List = cache["blocks"] if mode == "decode" \
            else [None] * len(self.blocks)
        run = _remat(remat) if torch.is_grad_enabled() else None
        caches_out = []
        for block, cin in zip(self.blocks, caches_in):
            if run is None:
                h, nc = block(h, cin, positions, mode)
            else:
                h, nc = run(block, h, cin, positions, mode)
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


def _remat(remat: str):
    """The per-layer call for ``remat`` (None: call the layer as it is)."""
    if remat == "none":
        return None
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    return functools.partial(ckpt.checkpoint, use_reentrant=False, **kw)
