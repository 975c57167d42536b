"""Unified model API of the port (the ``--arch`` dispatch point).

``build_model(cfg, device)`` returns a :class:`Model` exposing:

    init_params(seed)              -> params (a ``transformer.Transformer``)
    params_from_reference(tree)    -> params carried over from the JAX
                                      reference's parameter tree
    param_shapes()                 -> the parameter tree as meta tensors
    apply(params, batch, mode, cache=None, remat="full")
                                   -> (logits, new_cache)
    init_cache(batch, max_seq=None)

``params`` plays the part of the reference's parameter pytree: an
``nn.Module`` that holds the weights on the model's device, trainable.
The port runs the dense, moe, hybrid and ssm families; the vlm and
audio families raise ``NotImplementedError`` (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.ops import resolve_device
from . import transformer
from .params import init_from_specs, params_from_reference, shapes_from_specs


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # ------------------------------------------------------------ params
    def init_params(self, seed: int) -> transformer.Transformer:
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tree = init_from_specs(transformer.param_specs(self.cfg), gen,
                               self.dtype)
        return transformer.Transformer(self.cfg, tree)

    def params_from_reference(self, tree: Mapping
                              ) -> transformer.Transformer:
        """The JAX reference's parameters (numpy arrays in its tree
        layout) on the model's device."""
        cfg = self.cfg
        return transformer.Transformer(cfg, params_from_reference(
            tree, transformer.param_specs(cfg), cfg.scan_period,
            self.dtype, self.device))

    def param_shapes(self) -> Dict:
        """The parameter tree as meta tensors (no allocation)."""
        return shapes_from_specs(transformer.param_specs(self.cfg),
                                 self.dtype)

    # ------------------------------------------------------------ apply
    def apply(self, params: transformer.Transformer, batch: Dict, *,
              mode: str = "train", cache: Optional[Dict] = None,
              remat: str = "full"):
        if set(batch) != {"tokens"}:
            raise NotImplementedError(
                f"inputs {sorted(batch)}: the port takes tokens only "
                "(ROADMAP queue 1 item 4)")
        return params(batch["tokens"], cache=cache, mode=mode, remat=remat)

    # ------------------------------------------------------------ cache
    def init_cache(self, batch: int, max_seq: Optional[int] = None) -> Dict:
        """An empty decode cache.  ``max_seq`` (the KV rows) is required
        only when the model has attention layers: a Mamba cache does not
        grow with the sequence."""
        return transformer.init_cache(self.cfg, batch, max_seq, self.dtype,
                                      self.device)


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device``: ``None`` means the card and
    raises without one; ``"cpu"`` runs the kernels' plain versions."""
    transformer.check_supported(cfg)
    return Model(cfg, resolve_device(device))
