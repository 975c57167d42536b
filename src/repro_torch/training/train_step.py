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
from ..sharding import local_shard, shard
from .optimizer import AdamWConfig, AdamWState, adamw_update, named_params


@dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    remat: str = "full"                 # full | dots | none
    z_loss: float = 0.0                 # logit-norm regularizer (0 = off)


def log_sum_exp(lg: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last axis.  A DTensor (the dry-run) is
    reduced on each device's shards (:class:`_LogSumExp`): DTensor's own
    builds its backward at the global shape."""
    from torch.distributed.tensor import DTensor
    if isinstance(lg, DTensor):
        return _LogSumExp.apply(lg)
    return torch.logsumexp(lg, dim=-1)


def _shards(lg):
    """lg's placements with batch (dim 0) and vocabulary (dim 2) shards
    kept and the rest gathered, and its local tensor so placed."""
    from torch.distributed.tensor import Replicate, Shard
    place = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                  else Replicate() for p in lg.placements)
    return place, lg.redistribute(lg.device_mesh, place).to_local()


class _LogSumExp(torch.autograd.Function):
    """The vocabulary-parallel ``logsumexp``: each device's max and sum of
    exponentials over its shard, combined by all-reduces over the
    vocabulary's mesh dims."""

    @staticmethod
    def forward(ctx, lg):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        mesh = lg.device_mesh
        place, local = _shards(lg)
        red = lambda t, op: DTensor.from_local(
            t, mesh, tuple(Partial(op) if p == Shard(2) else p
                           for p in place),
            run_check=False).redistribute(
                mesh, tuple(Replicate() if p == Shard(2) else p
                            for p in place)).to_local()
        top = red(local.amax(-1), "max")
        lse = top + red((local - top[..., None]).exp().sum(-1), "sum").log()
        ctx.save_for_backward(local, lse)
        ctx.meta = (mesh, place)
        oplace = tuple(Replicate() if p == Shard(2) else p for p in place)
        return DTensor.from_local(lse, mesh, oplace, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        local, lse = ctx.saved_tensors
        mesh, place = ctx.meta
        gplace = tuple(Replicate() if p == Shard(2) else p for p in place)
        g = grad.redistribute(mesh, gplace).to_local()
        gl = g[..., None] * (local - lse[..., None]).exp()
        return DTensor.from_local(gl, mesh, place, run_check=False)


def target_logits(lg: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """lg [B, S, V] at targets [B, S] -> [B, S, 1].  A DTensor (the
    dry-run) is read on each device's shards (:class:`_TargetLogits`):
    DTensor's own gather builds its backward at the global shape."""
    from torch.distributed.tensor import DTensor
    if isinstance(lg, DTensor):
        return _TargetLogits.apply(lg, targets)
    return torch.gather(lg, -1, targets[..., None])


class _TargetLogits(torch.autograd.Function):
    """The vocabulary-parallel gather: each device picks the targets that
    fall in its shard of the vocabulary (zero elsewhere), so the result
    is a partial sum over the vocabulary's mesh dims; batch shards are
    kept, anything else is gathered first."""

    @staticmethod
    def forward(ctx, lg, targets):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        mesh = lg.device_mesh
        place, local = _shards(lg)
        tplace = tuple(p if p == Shard(0) else Replicate() for p in place)
        t = local_shard(targets, mesh, tplace)
        _, off = compute_local_shape_and_global_offset(lg.shape, mesh, place)
        li = t.long() - off[2]
        inside = ((li >= 0) & (li < local.shape[2]))[..., None]
        li = li.clamp(0, local.shape[2] - 1)[..., None]
        ctx.save_for_backward(li, inside)
        ctx.meta = (mesh, place, local.shape, local.dtype)
        out = torch.where(inside, torch.gather(local, -1, li),
                          torch.zeros((), dtype=local.dtype,
                                      device=local.device))
        oplace = tuple(Partial() if p == Shard(2) else p for p in place)
        return DTensor.from_local(out, mesh, oplace, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        li, inside = ctx.saved_tensors
        mesh, place, shape, dtype = ctx.meta
        gplace = tuple(Replicate() if p == Shard(2) else p for p in place)
        g = grad.redistribute(mesh, gplace).to_local()
        gl = torch.zeros(shape, dtype=dtype, device=g.device).scatter_(
            -1, li, torch.where(inside, g, torch.zeros_like(g)).to(dtype))
        return DTensor.from_local(gl, mesh, place, run_check=False), None


def make_loss_fn(model: Model, tcfg: TrainStepConfig) -> Callable:
    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict]:
        logits, _ = model.apply(params, batch, mode="train", remat=tcfg.remat)
        tokens = batch["tokens"]
        if model.cfg.family == "vlm":       # no targets at patch positions
            logits = logits[:, model.cfg.vision_patches:, :]
        targets = tokens[:, 1:].long()
        lg = logits[:, :-1, :].to(torch.float32)
        lse = log_sum_exp(lg)
        ll = target_logits(lg, targets)
        loss = (lse[..., None] - ll).mean()
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
        gacc = {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in named_params(params).items()}
        lacc = 0.0
        for i in range(m):
            # a batch-sharded DTensor (the dry-run) keeps each
            # micro-batch on the batch shards
            mb = {k: shard(x[i * n:(i + 1) * n], "batch")
                  for k, x in batch.items()}
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
