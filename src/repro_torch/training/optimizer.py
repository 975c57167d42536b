"""AdamW (decoupled weight decay) with distributed-scale options:

* configurable optimizer-state dtype (fp32 default; bf16 halves the
  optimizer footprint);
* optional gradient compression with error feedback (bf16 cast; the
  feedback buffer keeps the quantization error from accumulating);
* cosine LR schedule with linear warmup.

``params`` is the model's ``nn.Module`` (or a dict of tensors);
optimizer state holds one tensor per parameter name.  The update writes
the new parameters into ``params`` in place (the reference donates its
parameter buffers) and returns it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"
    grad_compression: str = "none"      # none | bf16_ef
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor                  # int32 scalar
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    ef: Optional[Dict[str, torch.Tensor]]   # error-feedback buffers


def named_params(params) -> Dict[str, torch.Tensor]:
    """name -> tensor of an ``nn.Module``'s parameters, or of a dict."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


#: the parameter names whose leaves the reference stacks along a leading
#: axis (periods of the decoder-only stack; the encoder-decoder's layers)
STACKED = ("blocks.", "enc_blocks.", "dec_blocks.")


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The rank of parameter ``name`` in the reference's tree, where every
    block leaf carries a leading stacking axis: the port's rank, plus one
    under ``blocks``, ``enc_blocks`` and ``dec_blocks``."""
    return p.ndim + name.startswith(STACKED)


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """float32 learning rate at ``step`` (int or int tensor)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1),
                       max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(torch.float32)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    named = named_params(params)
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda d: {n: torch.zeros(p.shape, dtype=d, device=p.device)
                       for n, p in named.items()}
    device = next(iter(named.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=zeros(dt), v=zeros(dt),
        ef=zeros(torch.float32) if cfg.grad_compression == "bf16_ef"
        else None)


def _compress(grads, ef):
    """bf16 gradient compression with error feedback: (float32 grads
    rounded through bf16, new error buffers)."""
    comp, new_ef = {}, {}
    for n, g in grads.items():
        gf = g.to(torch.float32) + ef[n]
        gq = gf.to(torch.bfloat16).to(torch.float32)
        comp[n], new_ef[n] = gq, gf - gq
    return comp, new_ef


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], state: AdamWState, params,
                 cfg: AdamWConfig) -> Tuple[object, AdamWState, torch.Tensor]:
    """Returns (params updated in place, new_state, lr).

    Weight decay applies to a leaf of rank >= 2 in the reference's tree
    (:func:`reference_ndim`): every block leaf, norms and biases
    included, and the top-level matrices, but not the top-level norms
    (``final_norm``, ``enc_final_norm``)."""
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    new_ef = state.ef
    if cfg.grad_compression == "bf16_ef":
        grads, new_ef = _compress(grads, state.ef)

    b1, b2 = cfg.b1, cfg.b2
    sdt = getattr(torch, cfg.state_dtype)
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    new_m, new_v = {}, {}
    for n, p in named_params(params).items():
        g = grads[n].to(torch.float32)
        m32 = state.m[n].to(torch.float32) * b1 + (1 - b1) * g
        v32 = state.v[n].to(torch.float32) * b2 + (1 - b2) * g.square()
        delta = (m32 / bc1) / ((v32 / bc2).sqrt() + cfg.eps)
        pf = p.to(torch.float32)
        if reference_ndim(n, p) >= 2:
            delta = delta + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
        new_m[n], new_v[n] = m32.to(sdt), v32.to(sdt)
    return params, AdamWState(step=step, m=new_m, v=new_v, ef=new_ef), lr


def opt_state_logical_axes(param_axes, cfg: AdamWConfig) -> AdamWState:
    """Optimizer state shards exactly like its parameters (ZeRO-style).
    ``param_axes`` is keyed by parameter name, as the state is
    (:func:`named_axes`)."""
    ef = param_axes if cfg.grad_compression == "bf16_ef" else None
    return AdamWState(step=(), m=param_axes, v=param_axes, ef=ef)


def named_axes(axes_tree) -> Dict[str, tuple]:
    """A model's logical-axes tree (``Model.param_logical_axes``) keyed
    by parameter name, as ``named_params`` names the parameters
    (``blocks.3.wq``)."""
    out: Dict[str, tuple] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, list):
            items = enumerate(node)
        else:
            out[prefix] = node
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))
    walk(axes_tree, "")
    return out
