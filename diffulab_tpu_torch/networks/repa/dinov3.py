"""DINOv3 REPA encoder (port of diffulab_tpu/networks/repa/dinov3.py;
reference src/diffulab/networks/repa/dinov3.py:22-116).

The HF DINOv3 ViT (:class:`~diffulab_tpu_torch.networks.repa.vit.Dinov3ViTEncoder`);
``cancel_affine`` drops the final norm's affine parameters (reference
:37-41). Weights come from a local HF checkpoint directory
(``weights_path``: config.json and safetensors shards, read without the
safetensors package), whose config sets the architecture; without one the
registry's architecture keeps its random init. The cls and register tokens
are stripped from the output (reference :115).
"""

from __future__ import annotations

from pathlib import Path

import torch

from diffulab_tpu_torch.networks.repa.common import REPA, bicubic_resize, normalize_imagenet
from diffulab_tpu_torch.networks.repa.vit import (
    Dinov3ViTEncoder,
    build_dinov3_from_config,
    load_dinov3_state_dict,
    load_hf_checkpoint_dir,
)

DINOV3_CONFIGS = {
    "facebook/dinov3-vits16-pretrain-lvd1689m": dict(
        embed_dim=384, depth=12, num_heads=6, intermediate_size=1536, use_gated_mlp=False),
    "facebook/dinov3-vitb16-pretrain-lvd1689m": dict(
        embed_dim=768, depth=12, num_heads=12, intermediate_size=3072, use_gated_mlp=False),
    "facebook/dinov3-vitl16-pretrain-lvd1689m": dict(
        embed_dim=1024, depth=24, num_heads=16, intermediate_size=4096, use_gated_mlp=True),
}


class DinoV3(REPA):
    base_patch_pixel_size: int = 16

    def __init__(
        self,
        dino_model: str = "facebook/dinov3-vitb16-pretrain-lvd1689m",
        cancel_affine: bool = False,
        resolution: int = 224,
        weights_path: str | Path | None = None,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__()
        self.inference_resolution = resolution
        if weights_path is not None:
            cfg, state = load_hf_checkpoint_dir(weights_path)
            self._encoder = build_dinov3_from_config(cfg, final_norm_affine=not cancel_affine, device=device)
            load_dinov3_state_dict(self._encoder, state)
            self._embedding_dim = int(cfg.get("hidden_size", 768))
        else:
            if dino_model not in DINOV3_CONFIGS:
                raise ValueError(f"unknown dinov3 model {dino_model}")
            cfg = DINOV3_CONFIGS[dino_model]
            self._encoder = Dinov3ViTEncoder(patch_size=self.base_patch_pixel_size, num_register_tokens=4,
                                             final_norm_affine=not cancel_affine, **cfg, device=device)
            self._embedding_dim = cfg["embed_dim"]
        self._encoder.requires_grad_(False)

    @property
    def encoder(self) -> Dinov3ViTEncoder:
        return self._encoder

    @property
    def embedding_dim(self) -> int:
        return self._embedding_dim

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        return bicubic_resize(normalize_imagenet(x), self.inference_resolution)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> normalised patch tokens ``[B, N, D]``, without gradients."""
        with torch.no_grad():
            return self._encoder(self.preprocess(x))["patch_tokens"]
