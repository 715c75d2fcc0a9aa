"""Flux2 VAE tower (port of diffulab_tpu/networks/vision_towers/flux2.py).

A KL conv VAE whose latents are packed with a 2x2 pixel shuffle (4x the
latent channels, one more 2x of spatial compression). The latent scale and
bias come from the checkpoint's batch-norm running stats. Weights load from
a diffusers checkpoint through ``weights_path`` (a ``.npz`` of the numpy
state dict, or a torch ``.bin``/``.pt``).

A tower trained in-framework (``flax_ckpt``, flux2.py:76-95) is a checkpoint
directory in the port's format, as :func:`save_tower_checkpoint` writes it:
the encoder's and decoder's state dicts and the per-channel
``latent_scale`` / ``latent_bias`` ``[1, 1, 1, 4 * latent_channels]`` of the
training distribution, which replace the batch-norm statistics. The port's
builder (``diffulab_tpu_torch.scripts.build_hard_txt2img``) writes one, and
so does ``scripts/import_orbax_checkpoint.py`` from a JAX package tower (an
orbax directory, which this constructor refuses, naming that importer).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from diffulab_tpu_torch.networks.vision_towers.common import VisionTower, normalize_to_pm1
from diffulab_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from diffulab_tpu_torch.networks.vision_towers.vae import (
    VAEDecoder,
    VAEEncoder,
    diagonal_gaussian_sample,
    load_autoencoder_kl_state_dict,
)
from diffulab_tpu_torch.utils import resolve_device


def _load_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


class Flux2VAE(VisionTower):
    def __init__(
        self,
        base_channels: int = 128,
        ch_mult: tuple[int, ...] = (1, 2, 4, 4),
        num_res_blocks: int = 2,
        latent_channels: int = 16,
        batch_norm_eps: float = 1e-4,
        weights_path: str | Path | None = None,
        flax_ckpt: str | Path | None = None,
        bn_running_mean: np.ndarray | None = None,
        bn_running_var: np.ndarray | None = None,
        *,
        dtype=None,
        param_dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ) -> None:
        device = resolve_device(device)
        packed = latent_channels * 4
        sd = _load_state_dict(weights_path) if weights_path is not None else None
        if sd is not None and "bn.running_mean" in sd:
            bn_running_mean, bn_running_var = sd["bn.running_mean"], sd["bn.running_var"]
        saved = restore_checkpoint(flax_ckpt) if flax_ckpt is not None else None
        if saved is not None:
            stats = {}
            for name in ("latent_scale", "latent_bias"):
                value = torch.as_tensor(saved[name], dtype=torch.float32)
                if tuple(value.shape) != (1, 1, 1, packed):
                    raise ValueError(f"{flax_ckpt}: {name} {tuple(value.shape)}, expected (1, 1, 1, {packed})")
                stats[name] = value.to(device)
            super().__init__(**stats)
        elif bn_running_mean is not None:
            scale = 1.0 / np.sqrt(np.asarray(bn_running_var) + batch_norm_eps)
            # NHWC: per-channel stats broadcast over [B, H', W', C]
            super().__init__(
                latent_scale=torch.as_tensor(scale, dtype=torch.float32, device=device).reshape(1, 1, 1, packed),
                latent_bias=torch.as_tensor(np.asarray(bn_running_mean), dtype=torch.float32,
                                            device=device).reshape(1, 1, 1, packed),
            )
        else:
            super().__init__(latent_scale=1.0, latent_bias=0.0)
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.encoder = VAEEncoder(3, base_channels, ch_mult, num_res_blocks, latent_channels, double_z=True, **kw)
        self.decoder = VAEDecoder(3, base_channels, ch_mult, num_res_blocks, latent_channels, **kw)
        self._latent_channels = packed  # 2x2 packing
        # 2**len(ch_mult): the conv stages' 2**(levels - 1) times the 2x packing
        self._compression_factor = 2 ** len(ch_mult)
        if sd is not None:
            load_autoencoder_kl_state_dict(self.encoder, self.decoder, sd)
        if saved is not None:
            self.encoder.load_state_dict(saved["encoder"], strict=True)
            self.decoder.load_state_dict(saved["decoder"], strict=True)

    @property
    def compression_factor(self) -> int:
        return self._compression_factor

    @property
    def latent_channels(self) -> int:
        return self._latent_channels

    def encode(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """NHWC image -> packed latents [B, H/2f, W/2f, 4*z]; the mean of the
        posterior without ``generator``, a sample drawn with it otherwise."""
        x = normalize_to_pm1(x)
        z = diagonal_gaussian_sample(self.encoder(x), generator)  # [B, h, w, z]
        b, h, w, c = z.shape
        # 2x2 pixel-shuffle packing (flux2.py:116-123)
        z = z.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        return z.reshape(b, h // 2, w // 2, c * 4)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Packed NHWC latents -> NHWC image (flux2.py:125-133)."""
        b, h, w, c = z.shape
        zc = c // 4
        z = z.reshape(b, h, w, zc, 2, 2).permute(0, 1, 4, 2, 5, 3)
        return self.decoder(z.reshape(b, h * 2, w * 2, zc))


def save_tower_checkpoint(path: str | Path, encoder: dict[str, torch.Tensor], decoder: dict[str, torch.Tensor],
                          latent_scale, latent_bias) -> None:
    """Write a trained tower as the directory ``Flux2VAE(flax_ckpt=path)``
    reads: the encoder's and decoder's state dicts and the per-channel latent
    statistics as fp32 ``[1, 1, 1, C]`` (build_hard_txt2img.py:103-108)."""
    c = np.asarray(latent_scale).size
    save_checkpoint(path, {
        "encoder": encoder,
        "decoder": decoder,
        "latent_scale": torch.as_tensor(np.asarray(latent_scale, np.float32).reshape(1, 1, 1, c)),
        "latent_bias": torch.as_tensor(np.asarray(latent_bias, np.float32).reshape(1, 1, 1, c)),
    })
