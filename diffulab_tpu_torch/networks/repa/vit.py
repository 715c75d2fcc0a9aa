"""DINO-style ViT encoders (port of diffulab_tpu/networks/repa/vit.py).

:class:`ViTEncoder` (vit.py:20-140): patch embedding, a cls token and
optional register tokens, a learned absolute position embedding, pre-norm
blocks (LayerNorm eps 1e-6, optional LayerScale, an exact-GELU MLP: trap T2,
vit.py:56) and a final LayerNorm. :func:`load_dinov2_state_dict` loads a
facebookresearch/dinov2 torch state dict into it, the position table
resampled to the target grid by :func:`resample_abs_pos_embed` (the
reference's ``jax.image.resize`` bicubic, trap T3).

:class:`Dinov3ViTEncoder` (vit.py:192-386) is the HF DINOv3ViTModel
architecture in eval mode: [cls; registers; patches], RoPE over normalised
patch centres (no position table), separate q/k/v projections, LayerScale,
a plain or gated exact-GELU MLP. :func:`load_hf_checkpoint_dir` reads an HF
checkpoint directory (config.json and safetensors shards, parsed in NumPy:
an 8-byte header length, a JSON header, raw little-endian bytes; bf16
widened through uint16) and :func:`load_dinov3_state_dict` loads it.

The attention of both is ``jax.nn.dot_product_attention`` in the
reference, XLA's own op rather than a Pallas kernel, so here it is
``F.scaled_dot_product_attention`` (the 1/sqrt(head_dim) scale, no mask).

:meth:`ViTEncoder.draw_jax_params` gives the encoder the weights the JAX
constructor draws from ``nnx.Rngs(seed)``, through :mod:`..jax_prng` (trap
T24): the frozen ``FixedViT`` target is defined by that stream.
"""

from __future__ import annotations

import json
from pathlib import Path
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffulab_tpu_torch import jax_prng
from diffulab_tpu_torch.networks.nn import Conv2d, Linear
from diffulab_tpu_torch.networks.repa.common import keys_cubic_weights
from diffulab_tpu_torch.utils import resolve_device
from diffulab_tpu_torch.weights import copy_checked_, state_dict_from_jax


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


def resample_abs_pos_embed(pos_embed: np.ndarray, new_grid: tuple[int, int],
                           num_prefix_tokens: int = 1) -> np.ndarray:
    """Bicubic resample of a ``[1, P+N, D]`` position table to a new token
    grid (vit.py:62; timm's ``resample_abs_pos_embed``), with the weights of
    ``jax.image.resize(..., "bicubic")`` (trap T3)."""
    pos_embed = np.asarray(pos_embed, np.float32)
    prefix, grid = pos_embed[:, :num_prefix_tokens], pos_embed[:, num_prefix_tokens:]
    old_side = int(round(grid.shape[1] ** 0.5))
    if (old_side, old_side) == tuple(new_grid):
        return pos_embed
    d = grid.shape[-1]
    grid = grid.reshape(old_side, old_side, d)
    wh = keys_cubic_weights(old_side, new_grid[0])
    ww = keys_cubic_weights(old_side, new_grid[1])
    grid = np.einsum("hwd,hy,wx->yxd", grid, wh, ww).astype(np.float32)
    return np.concatenate([prefix, grid.reshape(1, new_grid[0] * new_grid[1], d)], axis=1)


def _put_linear(layer: Linear, state_dict: dict[str, np.ndarray], prefix: str) -> None:
    copy_checked_(layer.weight, state_dict[prefix + ".weight"], prefix + ".weight")  # torch [out, in] on both sides
    if layer.bias is not None and prefix + ".bias" in state_dict:
        copy_checked_(layer.bias, state_dict[prefix + ".bias"], prefix + ".bias")


def load_dinov2_state_dict(model: ViTEncoder, state_dict: dict[str, np.ndarray],
                           target_grid: tuple[int, int] | None = None) -> None:
    """Load a facebookresearch/dinov2 torch state dict (numpy arrays) into a
    :class:`ViTEncoder` (vit.py:143), the position table resampled to
    ``target_grid`` when given. Register tokens and LayerScale load where the
    checkpoint has them, the final norm where the model keeps its affine."""
    copy_checked_(model.patch_embed.weight, state_dict["patch_embed.proj.weight"], "patch_embed.proj.weight")
    copy_checked_(model.patch_embed.bias, state_dict["patch_embed.proj.bias"], "patch_embed.proj.bias")
    copy_checked_(model.cls_token, state_dict["cls_token"], "cls_token")
    if model.register_tokens is not None and "register_tokens" in state_dict:
        copy_checked_(model.register_tokens, state_dict["register_tokens"], "register_tokens")
    pos = state_dict["pos_embed"]
    if target_grid is not None:
        pos = resample_abs_pos_embed(pos, target_grid)
    copy_checked_(model.pos_embed, pos, "pos_embed")
    for i, block in enumerate(model.blocks):
        pre = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            copy_checked_(getattr(block, norm).weight, state_dict[pre + norm + ".weight"], pre + norm + ".weight")
            copy_checked_(getattr(block, norm).bias, state_dict[pre + norm + ".bias"], pre + norm + ".bias")
        _put_linear(block.attn.qkv, state_dict, pre + "attn.qkv")
        _put_linear(block.attn.proj, state_dict, pre + "attn.proj")
        _put_linear(block.fc1, state_dict, pre + "mlp.fc1")
        _put_linear(block.fc2, state_dict, pre + "mlp.fc2")
        if block.ls1 is not None and pre + "ls1.gamma" in state_dict:
            copy_checked_(block.ls1, state_dict[pre + "ls1.gamma"], pre + "ls1.gamma")
            copy_checked_(block.ls2, state_dict[pre + "ls2.gamma"], pre + "ls2.gamma")
    if "norm.weight" in state_dict and model.norm.elementwise_affine:
        copy_checked_(model.norm.weight, state_dict["norm.weight"], "norm.weight")
        copy_checked_(model.norm.bias, state_dict["norm.bias"], "norm.bias")


# --------------------------------------------------------------------------- #
# DINOv3 (HF transformers DINOv3ViTModel architecture)
# --------------------------------------------------------------------------- #


def dinov3_rope_cos_sin(num_patches_h: int, num_patches_w: int, head_dim: int, theta: float = 100.0,
                        device: str | torch.device | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE tables over normalised patch-centre coordinates, eval mode
    (vit.py:192): ``(cos, sin)`` of shape ``[num_patches_h * num_patches_w,
    head_dim]``, formed in float64 and rounded to fp32."""
    inv_freq = 1.0 / theta ** np.arange(0, 1, 4 / head_dim, dtype=np.float64)  # (hd/4,)
    ch = (np.arange(0.5, num_patches_h, dtype=np.float64) / num_patches_h) * 2.0 - 1.0
    cw = (np.arange(0.5, num_patches_w, dtype=np.float64) / num_patches_w) * 2.0 - 1.0
    hh, ww = np.meshgrid(ch, cw, indexing="ij")
    coords = np.stack([hh.reshape(-1), ww.reshape(-1)], axis=-1)  # (N, 2): (y, x)
    angles = 2.0 * np.pi * coords[:, :, None] * inv_freq[None, None, :]  # (N, 2, hd/4)
    angles = np.tile(angles.reshape(angles.shape[0], -1), (1, 2))  # (N, hd)
    return (torch.as_tensor(np.cos(angles), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(angles), dtype=torch.float32, device=device))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


class Dinov3Attention(nn.Module):
    """Separate q/k/v projections with per-projection bias flags; RoPE on the
    patch tokens only, the cls and register tokens unrotated (vit.py:220)."""

    def __init__(self, dim: int, num_heads: int, *, query_bias=True, key_bias=False, value_bias=True,
                 proj_bias=True, device=None, param_dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        kw = dict(device=device, param_dtype=param_dtype)
        self.q_proj = Linear(dim, dim, bias=query_bias, **kw)
        self.k_proj = Linear(dim, dim, bias=key_bias, **kw)
        self.v_proj = Linear(dim, dim, bias=value_bias, **kw)
        self.o_proj = Linear(dim, dim, bias=proj_bias, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        n_prefix = n - cos.shape[0]
        c, s = cos[None, :, None, :].to(x.dtype), sin[None, :, None, :].to(x.dtype)

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, n, self.num_heads, self.head_dim)

        def rope(t: torch.Tensor) -> torch.Tensor:
            prefix, patches = t[:, :n_prefix], t[:, n_prefix:]
            return torch.cat([prefix, patches * c + _rotate_half(patches) * s], dim=1)

        q, k, v = rope(heads(self.q_proj(x))), rope(heads(self.k_proj(x))), heads(self.v_proj(x))
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return self.o_proj(out.transpose(1, 2).reshape(b, n, d))


class Dinov3Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate: int, use_gated_mlp: bool, eps: float = 1e-5, *,
                 mlp_bias=True, query_bias=True, key_bias=False, value_bias=True, proj_bias=True, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype)
        self.norm1 = nn.LayerNorm(dim, eps=eps, device=device, dtype=param_dtype)
        self.attn = Dinov3Attention(dim, num_heads, query_bias=query_bias, key_bias=key_bias, value_bias=value_bias,
                                    proj_bias=proj_bias, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=eps, device=device, dtype=param_dtype)
        self.up_proj = Linear(dim, intermediate, bias=mlp_bias, **kw)
        self.down_proj = Linear(intermediate, dim, bias=mlp_bias, **kw)
        self.gate_proj = Linear(dim, intermediate, bias=mlp_bias, **kw) if use_gated_mlp else None
        self.ls1 = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))
        self.ls2 = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), cos, sin) * self.ls1.to(x.dtype)
        h = self.norm2(x)
        if self.gate_proj is not None:  # exact GELU, as vit.py:271
            h = self.down_proj(F.gelu(self.gate_proj(h)) * self.up_proj(h))
        else:
            h = self.down_proj(F.gelu(self.up_proj(h)))
        return x + h * self.ls2.to(x.dtype)


class Dinov3ViTEncoder(nn.Module):
    """HF-architecture DINOv3 ViT (vit.py:279): returns the normalised patch
    tokens and the cls token; any input resolution works."""

    def __init__(
        self,
        patch_size: int = 16,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        intermediate_size: int | None = None,
        num_register_tokens: int = 4,
        use_gated_mlp: bool = False,
        rope_theta: float = 100.0,
        layer_norm_eps: float = 1e-5,
        final_norm_affine: bool = True,
        query_bias: bool = True,
        key_bias: bool = False,
        value_bias: bool = True,
        proj_bias: bool = True,
        mlp_bias: bool = True,
        *,
        device: str | torch.device | None = None,
        param_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        device = resolve_device(device)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_register_tokens = num_register_tokens
        self.head_dim = embed_dim // num_heads
        self.rope_theta = rope_theta
        intermediate_size = intermediate_size or 4 * embed_dim
        kw = dict(device=device, param_dtype=param_dtype)
        self.patch_embed = Conv2d(3, embed_dim, patch_size, stride=patch_size, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device, dtype=param_dtype))
        self.register_tokens = (
            nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim, device=device, dtype=param_dtype))
            if num_register_tokens > 0 else None
        )
        self.blocks = nn.ModuleList([
            Dinov3Block(embed_dim, num_heads, intermediate_size, use_gated_mlp, eps=layer_norm_eps, mlp_bias=mlp_bias,
                        query_bias=query_bias, key_bias=key_bias, value_bias=value_bias, proj_bias=proj_bias, **kw)
            for _ in range(depth)
        ])
        self.norm = nn.LayerNorm(embed_dim, eps=layer_norm_eps, elementwise_affine=final_norm_affine,
                                 device=device, dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: NHWC image -> ``{"patch_tokens": [B, N, D], "cls": [B, D]}``."""
        b, h, w, _ = x.shape
        tokens = self.patch_embed(x).reshape(b, -1, self.embed_dim)
        prefix = [self.cls_token.to(tokens.dtype).expand(b, 1, self.embed_dim)]
        if self.register_tokens is not None:
            prefix.append(self.register_tokens.to(tokens.dtype).expand(b, self.num_register_tokens, self.embed_dim))
        tokens = torch.cat(prefix + [tokens], dim=1)
        cos, sin = dinov3_rope_cos_sin(h // self.patch_size, w // self.patch_size, self.head_dim, self.rope_theta,
                                       device=tokens.device)
        for block in self.blocks:
            tokens = block(tokens, cos, sin)
        tokens = self.norm(tokens)
        n_prefix = 1 + self.num_register_tokens
        return {"patch_tokens": tokens[:, n_prefix:], "cls": tokens[:, 0]}


def build_dinov3_from_config(cfg: dict, *, final_norm_affine: bool = True,
                             device: str | torch.device | None = None) -> Dinov3ViTEncoder:
    """A :class:`Dinov3ViTEncoder` from an HF checkpoint directory's config.json (vit.py:362)."""
    return Dinov3ViTEncoder(
        patch_size=cfg.get("patch_size", 16),
        embed_dim=cfg.get("hidden_size", 768),
        depth=cfg.get("num_hidden_layers", 12),
        num_heads=cfg.get("num_attention_heads", 12),
        intermediate_size=cfg.get("intermediate_size"),
        num_register_tokens=cfg.get("num_register_tokens", 0),
        use_gated_mlp=cfg.get("use_gated_mlp", False),
        rope_theta=cfg.get("rope_theta", 100.0),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        final_norm_affine=final_norm_affine,
        query_bias=cfg.get("query_bias", True),
        key_bias=cfg.get("key_bias", False),
        value_bias=cfg.get("value_bias", True),
        proj_bias=cfg.get("proj_bias", True),
        mlp_bias=cfg.get("mlp_bias", True),
        device=device,
    )


def load_dinov3_state_dict(model: Dinov3ViTEncoder, state_dict: dict[str, np.ndarray]) -> None:
    """Load an HF DINOv3ViTModel state dict (numpy arrays; vit.py:386):
    ``embeddings.{cls_token,register_tokens,patch_embeddings.*}``,
    ``layer.{i}.*``, ``norm.*``; the pre-training ``mask_token`` is ignored."""
    copy_checked_(model.patch_embed.weight, state_dict["embeddings.patch_embeddings.weight"], "embeddings.patch_embeddings")
    copy_checked_(model.patch_embed.bias, state_dict["embeddings.patch_embeddings.bias"], "embeddings.patch_embeddings.bias")
    copy_checked_(model.cls_token, state_dict["embeddings.cls_token"], "embeddings.cls_token")
    if model.register_tokens is not None:
        copy_checked_(model.register_tokens, state_dict["embeddings.register_tokens"], "embeddings.register_tokens")
    for i, block in enumerate(model.blocks):
        pre = f"layer.{i}."
        for norm in ("norm1", "norm2"):
            copy_checked_(getattr(block, norm).weight, state_dict[pre + norm + ".weight"], pre + norm + ".weight")
            copy_checked_(getattr(block, norm).bias, state_dict[pre + norm + ".bias"], pre + norm + ".bias")
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _put_linear(getattr(block.attn, proj), state_dict, pre + "attention." + proj)
        copy_checked_(block.ls1, state_dict[pre + "layer_scale1.lambda1"], pre + "layer_scale1.lambda1")
        copy_checked_(block.ls2, state_dict[pre + "layer_scale2.lambda1"], pre + "layer_scale2.lambda1")
        _put_linear(block.up_proj, state_dict, pre + "mlp.up_proj")
        _put_linear(block.down_proj, state_dict, pre + "mlp.down_proj")
        if block.gate_proj is not None:
            _put_linear(block.gate_proj, state_dict, pre + "mlp.gate_proj")
    if model.norm.elementwise_affine:
        copy_checked_(model.norm.weight, state_dict["norm.weight"], "norm.weight")
        copy_checked_(model.norm.bias, state_dict["norm.bias"], "norm.bias")


#: safetensors dtype names -> numpy; BF16 is widened through uint16
_SAFETENSORS_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32,
                       "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """A safetensors file as numpy arrays, without the safetensors package:
    an 8-byte little-endian header length, a JSON header of ``{name: {dtype,
    shape, data_offsets}}``, then the raw bytes. BF16 tensors come back as
    fp32 (their bits shifted into the high half)."""
    raw = Path(path).read_bytes()
    n = int(np.frombuffer(raw[:8], "<u8")[0])
    header = json.loads(raw[8:8 + n])
    data = raw[8 + n:]
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        buf, shape = data[begin:end], tuple(info["shape"])
        if info["dtype"] == "BF16":
            out[name] = (np.frombuffer(buf, "<u2").astype(np.uint32) << 16).view(np.float32).reshape(shape)
        else:
            out[name] = np.frombuffer(buf, np.dtype(_SAFETENSORS_DTYPES[info["dtype"]]).newbyteorder("<")) \
                .reshape(shape).copy()
    return out


def load_hf_checkpoint_dir(path: str | Path) -> tuple[dict, dict[str, np.ndarray]]:
    """(config.json, the merged numpy state dict) of an HF checkpoint
    directory holding safetensors shards (vit.py:424)."""
    path = Path(path)
    cfg = json.loads((path / "config.json").read_text())
    shards = sorted(path.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    state: dict[str, np.ndarray] = {}
    for shard in shards:
        state.update(read_safetensors(shard))
    return cfg, state
