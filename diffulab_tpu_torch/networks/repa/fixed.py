"""Frozen fixed-seed ViT REPA encoder (port of diffulab_tpu/networks/repa/fixed.py).

The reference's REPA targets are pretrained DINOv2/v3 features, which need
downloaded checkpoints; without them the reproducible frozen feature space is
a randomly initialised ViT drawn from a fixed seed. Its weights are those the
JAX package's ``FixedViT(seed=...)`` draws from ``nnx.Rngs(seed)``,
reproduced by :mod:`diffulab_tpu_torch.jax_prng` (trap T24), so the port's
alignment target is the JAX package's.
"""

from __future__ import annotations

import torch

from diffulab_tpu_torch.networks.repa.common import REPA
from diffulab_tpu_torch.networks.repa.vit import ViTEncoder


class FixedViT(REPA):
    """Frozen fixed-seed ViT patch-token encoder (REPA interface)."""

    def __init__(
        self,
        img_size: int = 32,
        patch_size: int = 2,
        embed_dim: int = 384,
        depth: int = 6,
        num_heads: int = 6,
        seed: int = 4321,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__()
        self._encoder = ViTEncoder(
            img_size=img_size, patch_size=patch_size, embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            num_register_tokens=0, layerscale=False, device=device,
        )
        self._encoder.draw_jax_params(seed)
        self._encoder.requires_grad_(False)
        self._embedding_dim = embed_dim

    @property
    def encoder(self) -> ViTEncoder:
        return self._encoder

    @property
    def embedding_dim(self) -> int:
        return self._embedding_dim

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        return x  # synthetic pixel batches are already [-1, 1] at native size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Patch tokens ``[B, N, embed_dim]``, without gradients (fixed.py:57's stop_gradient)."""
        with torch.no_grad():
            return self._encoder(self.preprocess(x))["patch_tokens"]
