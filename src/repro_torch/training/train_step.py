"""Train step: next-token cross-entropy, micro-batched gradient
accumulation, AdamW update.

Micro-batching is the main activation-memory knob: the global batch
splits into M sequential micro-batches whose gradients accumulate in
float32 (a Python loop where the reference runs ``lax.scan``); peak
logits memory scales with 1/M while arithmetic is unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from ..models import Model
from .optimizer import AdamWConfig, AdamWState, adamw_update, named_params


@dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    remat: str = "full"                 # full | dots | none
    z_loss: float = 0.0                 # logit-norm regularizer (0 = off)


def make_loss_fn(model: Model, tcfg: TrainStepConfig) -> Callable:
    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict]:
        logits, _ = model.apply(params, batch, mode="train", remat=tcfg.remat)
        tokens = batch["tokens"]
        if model.cfg.family == "vlm":       # no targets at patch positions
            logits = logits[:, model.cfg.vision_patches:, :]
        targets = tokens[:, 1:].long()
        lg = logits[:, :-1, :].to(torch.float32)
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, targets[..., None])[..., 0]
        loss = (lse - ll).mean()
        if tcfg.z_loss:
            loss = loss + tcfg.z_loss * lse.square().mean()
        return loss, {"loss": loss, "ppl_proxy": loss}

    return loss_fn


def make_grad_fn(model: Model, tcfg: TrainStepConfig) -> Callable:
    """``grad_fn(params, batch) -> (grads by parameter name, loss)``: with
    one micro-batch the grads keep the parameters' type; with ``m`` they
    are float32 sums of each micro-batch's grads divided by ``m``, as
    the reference accumulates them."""
    loss_fn = make_loss_fn(model, tcfg)

    def single(params, batch):
        named = named_params(params)
        loss, _aux = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        return dict(zip(named, grads)), loss.detach()

    def accumulated(params, batch):
        m = tcfg.microbatches
        b = batch["tokens"].shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} micro-batches")
        n = b // m
        gacc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in named_params(params).items()}
        lacc = 0.0
        for i in range(m):
            mb = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
            grads, loss = single(params, mb)
            for k, g in grads.items():
                gacc[k].add_(g.to(torch.float32) / m)
            lacc = lacc + loss / m
        return gacc, lacc

    return accumulated if tcfg.microbatches > 1 else single


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    tcfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``params`` is updated in place and returned, and
    ``metrics`` holds ``loss``, ``grad_norm``, ``lr`` and ``step``."""
    grad_fn = make_grad_fn(model, tcfg)

    def train_step(params, opt_state: AdamWState, batch):
        grads, loss = grad_fn(params, batch)
        gnorm = torch.sqrt(sum(g.to(torch.float32).square().sum()
                               for g in grads.values()))
        params, new_state, lr = adamw_update(grads, opt_state, params,
                                             opt_cfg)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": new_state.step}
        return params, new_state, metrics

    return train_step
