"""DINO-style ViT encoder (port of diffulab_tpu/networks/repa/vit.py:20-140).

Patch embedding, a cls token and optional register tokens, a learned
absolute position embedding, pre-norm blocks (LayerNorm eps 1e-6, optional
LayerScale, an exact-GELU MLP: trap T2, vit.py:56) and a final LayerNorm.
The attention is ``jax.nn.dot_product_attention`` in the reference, XLA's
own op rather than a Pallas kernel, so here it is
``F.scaled_dot_product_attention`` (the 1/sqrt(head_dim) scale, no mask).

:meth:`ViTEncoder.draw_jax_params` gives the encoder the weights the JAX
constructor draws from ``nnx.Rngs(seed)``, through :mod:`..jax_prng` (trap
T24): the frozen ``FixedViT`` target is defined by that stream.

Not ported yet (ROADMAP queue 1, item 13b): ``load_dinov2_state_dict``,
``resample_abs_pos_embed`` and the DINOv3 RoPE ViT (vit.py:143-440), which
serve the pretrained encoders.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffulab_tpu_torch import jax_prng
from diffulab_tpu_torch.networks.nn import Conv2d, Linear
from diffulab_tpu_torch.utils import resolve_device
from diffulab_tpu_torch.weights import state_dict_from_jax


class ViTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, device=None, param_dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        kw = dict(device=device, param_dtype=param_dtype)
        self.qkv = Linear(dim, 3 * dim, **kw)
        self.proj = Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = (t.reshape(b, n, self.num_heads, self.head_dim).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, d))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, layerscale: bool = True, *,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype)
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, device=device, dtype=param_dtype)
        self.attn = ViTAttention(dim, num_heads, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, device=device, dtype=param_dtype)
        self.fc1 = Linear(dim, hidden, **kw)
        self.fc2 = Linear(hidden, dim, **kw)
        self.ls1 = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype)) if layerscale else None
        self.ls2 = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype)) if layerscale else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(self.norm1(x))
        if self.ls1 is not None:
            h = h * self.ls1.to(h.dtype)
        x = x + h
        h = self.fc2(F.gelu(self.fc1(self.norm2(x))))  # exact GELU, as the reference
        if self.ls2 is not None:
            h = h * self.ls2.to(h.dtype)
        return x + h


class ViTEncoder(nn.Module):
    """DINO-style ViT returning normalised patch tokens (vit.py:79)."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 14,
        embed_dim: int = 1024,
        depth: int = 24,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        num_register_tokens: int = 4,
        layerscale: bool = True,
        final_norm_affine: bool = True,
        *,
        device: str | torch.device | None = None,
        param_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        device = resolve_device(device)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_register_tokens = num_register_tokens
        grid = img_size // patch_size
        kw = dict(device=device, param_dtype=param_dtype)
        self.patch_embed = Conv2d(3, embed_dim, patch_size, stride=patch_size, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device, dtype=param_dtype))
        self.register_tokens = (
            nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim, device=device, dtype=param_dtype))
            if num_register_tokens > 0 else None
        )
        self.pos_embed = nn.Parameter(
            0.02 * torch.randn(1, grid * grid + 1, embed_dim, device=device, dtype=param_dtype))
        self.blocks = nn.ModuleList([ViTBlock(embed_dim, num_heads, mlp_ratio, layerscale, **kw)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6, elementwise_affine=final_norm_affine, device=device,
                                 dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: NHWC image -> ``{"patch_tokens": [B, N, D], "cls": [B, D]}``."""
        b = x.shape[0]
        tokens = self.patch_embed(x).reshape(b, -1, self.embed_dim)
        cls = self.cls_token.to(tokens.dtype).expand(b, 1, self.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(tokens.dtype)
        if self.register_tokens is not None:
            regs = self.register_tokens.to(tokens.dtype).expand(b, self.num_register_tokens, self.embed_dim)
            tokens = torch.cat([tokens[:, :1], regs, tokens[:, 1:]], dim=1)
        for block in self.blocks:
            tokens = block(tokens)
        tokens = self.norm(tokens)
        n_prefix = 1 + self.num_register_tokens
        return {"patch_tokens": tokens[:, n_prefix:], "cls": tokens[:, 0]}

    def jax_params(self, seed: int) -> dict[str, np.ndarray]:
        """The flat ``{path: array}`` parameters (JAX layout: Linear kernels
        ``[in, out]``, the Conv kernel HWIO) that the reference constructor
        draws from ``nnx.Rngs(seed)``. Its draw order: each Linear and Conv
        takes a key for its kernel (lecun normal) and one for its (zero)
        bias, each LayerNorm one for its scale and one for its bias, and
        ``pos_embed`` (0.02 x normal) one, between the patch embedding and the
        blocks; the zero tokens and the LayerScale ones take none."""
        rngs = jax_prng.Rngs(seed)
        params: dict[str, np.ndarray] = {}

        def dense(path: str, layer: nn.Module) -> None:
            # JAX's kernel layout: Linear [in, out], Conv HWIO
            shape = tuple(layer.weight.shape[::-1]) if layer.weight.ndim == 2 else tuple(
                layer.weight.permute(2, 3, 1, 0).shape)
            params[f"{path}/kernel"] = jax_prng.lecun_normal(rngs.params(), shape)
            rngs.params()
            params[f"{path}/bias"] = np.zeros(shape[-1], np.float32)

        def layer_norm(path: str, norm: nn.LayerNorm) -> None:
            if norm.elementwise_affine:
                rngs.params()
                params[f"{path}/scale"] = np.ones(norm.normalized_shape, np.float32)
                rngs.params()
                params[f"{path}/bias"] = np.zeros(norm.normalized_shape, np.float32)

        dense("patch_embed", self.patch_embed)
        params["cls_token"] = np.zeros(tuple(self.cls_token.shape), np.float32)
        if self.register_tokens is not None:
            params["register_tokens"] = np.zeros(tuple(self.register_tokens.shape), np.float32)
        params["pos_embed"] = np.float32(0.02) * jax_prng.normal(rngs.params(), tuple(self.pos_embed.shape))
        for i, block in enumerate(self.blocks):
            pre = f"blocks/{i}/"
            layer_norm(pre + "norm1", block.norm1)
            dense(pre + "attn/qkv", block.attn.qkv)
            dense(pre + "attn/proj", block.attn.proj)
            layer_norm(pre + "norm2", block.norm2)
            dense(pre + "fc1", block.fc1)
            dense(pre + "fc2", block.fc2)
            for name in ("ls1", "ls2"):
                if getattr(block, name) is not None:
                    params[pre + name] = np.ones(tuple(getattr(block, name).shape), np.float32)
        layer_norm("norm", self.norm)
        return params

    def draw_jax_params(self, seed: int) -> dict[str, np.ndarray]:
        """Load :meth:`jax_params` of ``seed`` into the encoder; returns them."""
        params = self.jax_params(seed)
        self.load_state_dict(state_dict_from_jax(params, self), strict=True)
        return params
