"""Unified model API of the port (the ``--arch`` dispatch point).

``build_model(cfg, device)`` returns a :class:`Model` exposing:

    init_params(seed)              -> params (a ``transformer.Transformer``,
                                      or an ``encdec.EncDec`` for audio)
    params_from_reference(tree)    -> params carried over from the JAX
                                      reference's parameter tree
    param_shapes()                 -> the parameter tree as meta tensors
    param_logical_axes()           -> each leaf's logical sharding axes
    apply(params, batch, mode, cache=None, remat="full")
                                   -> (logits, new_cache)
    init_cache(batch, max_seq=None, n_frames=None)
    cache_shapes(batch, max_seq) / cache_logical_axes()
    input_specs(shape_spec)        -> (meta tensors, logical axes) of one
                                      shape cell's inputs

``input_specs`` is the dry-run contract: meta stand-ins for every model
input of a given shape cell, with the modality frontends stubbed (audio
frames / vision patches arrive as precomputed embeddings).  The axes are
the reference's, less the leading ``"layers"`` axis of its stacked block
leaves: the port holds one leaf per layer.

``params`` plays the part of the reference's parameter pytree: an
``nn.Module`` that holds the weights on the model's device, trainable.
Every family of the repo runs: the decoder-only ones through
``transformer.py`` (a vlm batch adds ``patches``), the audio one through
``encdec.py`` (a train or prefill batch adds ``frames``).  The modality
frontends are stubs, as in the reference: patches and frames arrive as
precomputed embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..kernels.ops import resolve_device
from . import encdec, transformer
from .params import (init_from_specs, logical_axes_from_specs,
                     params_from_reference, shapes_from_specs)

WHISPER_CROSS_FRAMES = 1500      # 30 s window after conv downsampling


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    @property
    def _audio(self) -> bool:
        return self.cfg.family == "audio"

    # ------------------------------------------------------------ params
    def _specs(self) -> Dict:
        if self._audio:
            return encdec.param_specs(self.cfg)
        return transformer.param_specs(self.cfg)

    def _module(self, tree: Dict):
        cls = encdec.EncDec if self._audio else transformer.Transformer
        return cls(self.cfg, tree)

    def init_params(self, seed: int):
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._module(init_from_specs(self._specs(), gen, self.dtype))

    def params_from_reference(self, tree: Mapping):
        """The JAX reference's parameters (numpy arrays in its tree
        layout) on the model's device."""
        return self._module(params_from_reference(
            tree, self._specs(), self.cfg.scan_period, self.dtype,
            self.device))

    def param_shapes(self) -> Dict:
        """The parameter tree as meta tensors (no allocation)."""
        return shapes_from_specs(self._specs(), self.dtype)

    def param_logical_axes(self) -> Dict:
        return logical_axes_from_specs(self._specs())

    # ------------------------------------------------------------ apply
    def apply(self, params, batch: Dict, *, mode: str = "train",
              cache: Optional[Dict] = None, remat: str = "full"):
        """``batch["tokens"]``, with ``frames`` (audio) or ``patches``
        (any other family) where the batch has them."""
        if self._audio:
            extra = {"frames": batch.get("frames")}
        else:
            extra = {"patches": batch.get("patches")}
        return params(batch["tokens"], cache=cache, mode=mode, remat=remat,
                      **extra)

    # ------------------------------------------------------------ cache
    def init_cache(self, batch: int, max_seq: Optional[int] = None,
                   n_frames: Optional[int] = None) -> Dict:
        """An empty decode cache.  ``max_seq`` (the KV rows) is required
        only when the model has attention layers: a Mamba cache does not
        grow with the sequence.  An audio cache holds ``n_frames`` cross
        rows (default: the reference's WHISPER_CROSS_FRAMES); decode
        attends to all of them, so they must be the prefill's frames."""
        if self._audio:
            if max_seq is None:
                raise ValueError(f"{self.cfg.name}: an attention cache "
                                 "needs max_seq")
            return encdec.init_cache(
                self.cfg, batch, max_seq, n_frames or WHISPER_CROSS_FRAMES,
                self.dtype, self.device)
        return transformer.init_cache(self.cfg, batch, max_seq, self.dtype,
                                      self.device)

    def cache_shapes(self, batch: int, max_seq: int) -> Dict:
        """The decode cache as meta tensors (an audio cache with the
        reference's WHISPER_CROSS_FRAMES cross rows)."""
        if self._audio:
            return encdec.init_cache(self.cfg, batch, max_seq,
                                     WHISPER_CROSS_FRAMES, self.dtype, "meta")
        return transformer.init_cache(self.cfg, batch, max_seq, self.dtype,
                                      "meta")

    def cache_logical_axes(self) -> Dict:
        if self._audio:
            return encdec.cache_logical_axes(self.cfg)
        return transformer.cache_logical_axes(self.cfg)

    # ------------------------------------------------------------ inputs
    def input_specs(self, shape: ShapeSpec) -> Tuple[Dict, Dict]:
        """(meta tensor dict, logical-axes dict) for one shape cell."""
        cfg = self.cfg
        b = shape.global_batch
        meta = lambda *s, dtype=self.dtype: torch.empty(s, dtype=dtype,
                                                        device="meta")
        tok = lambda s: meta(b, s, dtype=torch.int32)
        tok_ax = ("batch", "seq")

        if shape.kind == "decode":
            return {"tokens": tok(1)}, {"tokens": ("batch", None)}

        if self._audio:
            # encoder frames at seq_len (conv-stub embeddings), decoder
            # tokens at seq_len//8 (mechanical teacher-forcing length)
            sd = max(shape.seq_len // 8, 8)
            specs = {"frames": meta(b, shape.seq_len, cfg.d_model),
                     "tokens": tok(sd)}
            axes = {"frames": ("batch", "seq", "embed_act"), "tokens": tok_ax}
            return specs, axes

        if cfg.family == "vlm":
            p = cfg.vision_patches
            specs = {"tokens": tok(shape.seq_len - p),
                     "patches": meta(b, p, cfg.d_model)}
            axes = {"tokens": tok_ax, "patches": ("batch", "seq", "embed_act")}
            return specs, axes

        return {"tokens": tok(shape.seq_len)}, {"tokens": tok_ax}


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device``: ``None`` means the card and
    raises without one; ``"cpu"`` runs the kernels' plain versions."""
    if cfg.family != "audio":
        transformer.check_supported(cfg)
    return Model(cfg, resolve_device(device))
