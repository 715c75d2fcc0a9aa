"""DINOv2 REPA encoder (port of diffulab_tpu/networks/repa/dinov2.py;
reference src/diffulab/networks/repa/dinov2.py:14-104).

A frozen DINOv2 ViT (default: ViT-L/14 with registers). The reference pulls
its weights through torch.hub; here they come from a local torch checkpoint
(``weights_path``), loaded by
:func:`~diffulab_tpu_torch.networks.repa.vit.load_dinov2_state_dict` with the
position table resampled to the inference grid. Without weights the
encoder keeps its random init. Pixels (0-1 or 0-255, NHWC) are normalised
with ImageNet's statistics and resized to ``inference_resolution`` =
224 * (resolution // 256), or to the square grid of ``target_seq_len``
tokens, by the reference's bicubic (trap T3). Patch tokens only, no
gradients.
"""

from __future__ import annotations

from pathlib import Path

import torch

from diffulab_tpu_torch.networks.repa.common import REPA, bicubic_resize, normalize_imagenet
from diffulab_tpu_torch.networks.repa.vit import ViTEncoder, load_dinov2_state_dict

DINOV2_CONFIGS = {
    "dinov2_vits14_reg": dict(embed_dim=384, depth=12, num_heads=6, num_register_tokens=4),
    "dinov2_vitb14_reg": dict(embed_dim=768, depth=12, num_heads=12, num_register_tokens=4),
    "dinov2_vitl14_reg": dict(embed_dim=1024, depth=24, num_heads=16, num_register_tokens=4),
    "dinov2_vits14": dict(embed_dim=384, depth=12, num_heads=6, num_register_tokens=0),
    "dinov2_vitb14": dict(embed_dim=768, depth=12, num_heads=12, num_register_tokens=0),
    "dinov2_vitl14": dict(embed_dim=1024, depth=24, num_heads=16, num_register_tokens=0),
}


class DinoV2(REPA):
    native_resolution: int = 224
    base_patch_pixel_size: int = 14

    def __init__(
        self,
        dino_model: str = "dinov2_vitl14_reg",
        resolution: int = 256,
        target_seq_len: int | None = None,
        weights_path: str | Path | None = None,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__()
        if dino_model not in DINOV2_CONFIGS:
            raise ValueError(f"unknown dinov2 model {dino_model}")
        cfg = DINOV2_CONFIGS[dino_model]
        if not target_seq_len:
            self.inference_resolution = self.native_resolution * (resolution // 256)
            grid_size = self.inference_resolution // self.base_patch_pixel_size
        else:
            sqrt_val = target_seq_len**0.5
            if not sqrt_val.is_integer():
                raise ValueError(f"target_seq_len ({target_seq_len}) must be a square")
            grid_size = int(sqrt_val)
            self.inference_resolution = grid_size * self.base_patch_pixel_size
        self._encoder = ViTEncoder(img_size=grid_size * self.base_patch_pixel_size,
                                   patch_size=self.base_patch_pixel_size, **cfg, device=device)
        self._embedding_dim = cfg["embed_dim"]
        if weights_path is not None:
            sd = torch.load(weights_path, map_location="cpu", weights_only=True)
            load_dinov2_state_dict(self._encoder, {k: v.float().numpy() for k, v in sd.items()},
                                   target_grid=(grid_size, grid_size))
        self._encoder.requires_grad_(False)

    @property
    def encoder(self) -> ViTEncoder:
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
