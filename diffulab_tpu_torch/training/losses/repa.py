"""REPA, the representation-alignment auxiliary loss (port of
diffulab_tpu/training/losses/repa.py).

Aligns the denoiser's tokens at ``alignment_layer`` to a frozen vision
encoder's features through a 3-layer SiLU projection MLP; the loss is
``coeff * (1 - mean cosine similarity)`` in fp32 (repa.py:118-126).
``set_model`` registers the 0-based layer in the denoiser's
``feature_layers``; the trainer runs the denoiser with
``capture_features=True`` and the loss reads the captured tokens from
``model_output["features"]``.

The encoder is computed live from x0. Ported: ``fixed_vit``
(:class:`~diffulab_tpu_torch.networks.repa.FixedViT`). Not ported yet
(``NotImplementedError``, ROADMAP queue 1, item 13b): the pretrained
``dinov2`` / ``dinov3`` encoders, the Perceiver resampler
(``use_resampler``) and precomputed features (``load_dino=False``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from diffulab_tpu_torch.networks.nn import Linear
from diffulab_tpu_torch.networks.repa.fixed import FixedViT
from diffulab_tpu_torch.training.losses.common import LossFunction
from diffulab_tpu_torch.utils import resolve_device

_ITEM_13B = "is not ported yet (ROADMAP queue 1, item 13b)"


class RepaLoss(LossFunction):
    #: the reference's registry; None marks an encoder not ported yet
    encoder_registry: dict[str, type | None] = {"dinov2": None, "dinov3": None, "fixed_vit": FixedViT}
    name: str = "RepaLoss"

    def __init__(
        self,
        repa_encoder: str = "dinov2",
        encoder_args: dict[str, Any] | None = None,
        alignment_layer: int = 8,  # 1-based layer index to align
        denoiser_dimension: int = 256,
        hidden_dim: int = 1024,
        load_dino: bool = True,
        embedding_dim: int = 768,
        use_resampler: bool = False,
        resampler_params: dict[str, Any] | None = None,
        coeff: float = 1.0,
        *,
        dtype: torch.dtype | None = None,
        param_dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__()
        if repa_encoder not in self.encoder_registry:
            raise ValueError(f"Encoder {repa_encoder} is not supported. Available: {list(self.encoder_registry)}")
        if not load_dino:
            raise NotImplementedError(f"REPA on precomputed features (load_dino=False) {_ITEM_13B}")
        if self.encoder_registry[repa_encoder] is None:
            raise NotImplementedError(f"the {repa_encoder} REPA encoder {_ITEM_13B}")
        if use_resampler:
            raise NotImplementedError(f"the Perceiver resampler (use_resampler) {_ITEM_13B}")
        del embedding_dim, resampler_params  # the precomputed-feature and resampler paths (13b)
        device = resolve_device(device)
        self.repa_encoder = self.encoder_registry[repa_encoder](**(encoder_args or {}), device=device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.proj_fc1 = Linear(denoiser_dimension, hidden_dim, **kw)
        self.proj_fc2 = Linear(hidden_dim, hidden_dim, **kw)
        self.proj_fc3 = Linear(hidden_dim, self.repa_encoder.embedding_dim, **kw)
        self.alignment_layer = alignment_layer
        self.coeff = coeff
        self._feature_index: int | None = None

    def set_model(self, model: Any) -> None:
        """Register the alignment layer in the denoiser's feature capture list (repa.py:80-89)."""
        layer_idx = self.alignment_layer - 1
        if not 0 <= layer_idx < len(model.layers):
            raise ValueError(f"alignment_layer {self.alignment_layer} out of range for {len(model.layers)} layers")
        layers = tuple(sorted(set(getattr(model, "feature_layers", ())) | {layer_idx}))
        model.feature_layers = layers
        self._feature_index = layers.index(layer_idx)

    def proj(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.proj_fc1(x))
        h = F.silu(self.proj_fc2(h))
        return self.proj_fc3(h)

    def forward(self, model_output: dict[str, Any], x0: torch.Tensor | None = None,
                dst_features: torch.Tensor | None = None, **_: Any) -> torch.Tensor:
        features = model_output.get("features")
        if not features or self._feature_index is None:
            raise RuntimeError("REPA: no captured features. Did you call set_model(...) and run the "
                               "denoiser with capture_features=True?")
        if dst_features is None:
            if x0 is None:
                raise ValueError("Either x0 or dst_features must be provided.")
            dst_features = self.repa_encoder(x0)
        p = self.proj(features[self._feature_index]).float()
        d = dst_features.float()
        cos_sim = (p * d).sum(-1) / (torch.linalg.vector_norm(p, dim=-1) * torch.linalg.vector_norm(d, dim=-1)
                                     + 1e-8)
        return self.coeff * (1.0 - cos_sim.mean())
