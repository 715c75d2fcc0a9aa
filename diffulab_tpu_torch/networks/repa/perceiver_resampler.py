"""Perceiver resampler (port of diffulab_tpu/networks/repa/perceiver_resampler.py;
reference src/diffulab/networks/repa/perceiver_resampler.py:14-252).

Learned latent tokens cross-attend the input sequence, whose keys get a
2-axis interleaved RoPE (the queries and the latents' own keys do not), with
the latents' keys and values appended; then a GELU feed-forward. ``depth``
times, then a final LayerNorm. The attention is an explicit einsum softmax
in fp32, as the reference's (:73-76): the sequences are small (num_latents x
N), and the JAX package runs no Pallas kernel here. The feed-forward's GELU
is ``jax.nn.gelu``'s default, the tanh approximation (:91, trap T2).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffulab_tpu_torch.networks.nn import Linear, get_cos_sin_ndim_grid
from diffulab_tpu_torch.utils import resolve_device


def _apply_rope_keys(k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, rotary_dim: int) -> torch.Tensor:
    """Interleaved N-D RoPE on keys ``[B, N, H, D]`` (:22): channel pairs
    (2i, 2i+1) rotate by the angle of cos/sin column i."""
    k_rope, k_pass = k[..., :rotary_dim], k[..., rotary_dim:]
    c = cos[None, :, None, :].to(k.dtype)
    s = sin[None, :, None, :].to(k.dtype)
    k_even, k_odd = k_rope[..., 0::2], k_rope[..., 1::2]
    k_rot = torch.stack([k_even * c - k_odd * s, k_even * s + k_odd * c], dim=-1).reshape(k_rope.shape)
    return torch.cat([k_rot, k_pass], dim=-1)


def _layer_norm(dim: int, device, param_dtype) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6, device=device, dtype=param_dtype)  # nnx.LayerNorm's epsilon


def _normed(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """nnx.LayerNorm: statistics in fp32, the output in ``dtype`` or, when
    None, in the promotion of the input's and the parameters' types."""
    return norm(x.float()).to(dtype or torch.promote_types(x.dtype, norm.weight.dtype))


class PerceiverAttention(nn.Module):
    """Latents query [inputs (RoPE'd keys); latents] (:36)."""

    def __init__(self, dim: int, axes_dim: Sequence[int], head_dim: int = 64, num_heads: int = 8, *,
                 device=None, dtype=None, param_dtype=torch.float32):
        super().__init__()
        self.scale = head_dim**-0.5
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.rotary_dim = int(sum(axes_dim))
        inner = head_dim * num_heads
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.norm_x = _layer_norm(dim, device, param_dtype)
        self.norm_latents = _layer_norm(dim, device, param_dtype)
        self.to_q = Linear(dim, inner, bias=False, **kw)
        self.to_kv = Linear(dim, inner * 2, bias=False, **kw)
        self.to_out = Linear(inner, dim, bias=False, **kw)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, latents: torch.Tensor, cos_sin) -> torch.Tensor:
        b, n, _ = x.shape
        m = latents.shape[1]
        x = _normed(self.norm_x, x, self.dtype)
        latents = _normed(self.norm_latents, latents, self.dtype)
        h, d = self.num_heads, self.head_dim
        q = self.to_q(latents).reshape(b, m, h, d)
        k_x, v_x = self.to_kv(x).chunk(2, dim=-1)
        k_l, v_l = self.to_kv(latents).chunk(2, dim=-1)
        cos, sin = cos_sin
        k_x = _apply_rope_keys(k_x.reshape(b, n, h, d), cos, sin, self.rotary_dim)
        k = torch.cat([k_x, k_l.reshape(b, m, h, d)], dim=1)  # [B, N+M, H, D]
        v = torch.cat([v_x.reshape(b, n, h, d), v_l.reshape(b, m, h, d)], dim=1)
        sim = torch.einsum("bmhd,bnhd->bhmn", q * self.scale, k).float()
        sim = sim - sim.amax(dim=-1, keepdim=True).detach()
        attn = sim.softmax(dim=-1).to(v.dtype)
        out = torch.einsum("bhmn,bnhd->bmhd", attn, v)
        return self.to_out(out.reshape(b, m, -1))


class PerceiverFeedForward(nn.Module):
    """LayerNorm -> Linear -> GELU (tanh, T2) -> Linear (:80)."""

    def __init__(self, dim: int, mult: float = 4, *, device=None, dtype=None, param_dtype=torch.float32):
        super().__init__()
        inner = int(dim * mult)
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.norm = _layer_norm(dim, device, param_dtype)
        self.fc1 = Linear(dim, inner, bias=False, **kw)
        self.fc2 = Linear(inner, dim, bias=False, **kw)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _normed(self.norm, x, self.dtype)
        return self.fc2(F.gelu(self.fc1(h), approximate="tanh"))


class PerceiverResampler(nn.Module):
    """Fixed-size latent summary of a token sequence (:94)."""

    def __init__(
        self,
        dim: int,
        depth: int,
        rope_axes_dim: Sequence[int] | None = None,
        head_dim: int = 64,
        num_heads: int = 8,
        ff_mult: int = 4,
        num_latents: int = 16,
        rope_base: int = 10_000,
        *,
        device: str | torch.device | None = None,
        dtype: torch.dtype | None = None,
        param_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        device = resolve_device(device)
        self.rope_base = rope_base
        if rope_axes_dim is None:
            d2 = head_dim // 2
            d2 -= d2 % 2
            rope_axes_dim = [d2, d2]  # (H, W)
        self.rope_axes_dim = list(rope_axes_dim)
        self.latents = nn.Parameter(torch.randn(num_latents, dim, device=device, dtype=param_dtype))
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.attn_layers = nn.ModuleList([PerceiverAttention(dim, self.rope_axes_dim, head_dim, num_heads, **kw)
                                          for _ in range(depth)])
        self.ff_layers = nn.ModuleList([PerceiverFeedForward(dim, ff_mult, **kw) for _ in range(depth)])
        self.norm = _layer_norm(dim, device, param_dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, cos_sin=None) -> torch.Tensor:
        if cos_sin is None:
            side = int(x.shape[1] ** 0.5)
            hh, ww = torch.meshgrid(torch.arange(side, device=x.device), torch.arange(side, device=x.device),
                                    indexing="ij")
            pos = torch.stack([hh.reshape(-1), ww.reshape(-1)], dim=-1)  # [N, 2]
            cos_sin = get_cos_sin_ndim_grid(pos, self.rope_base, self.rope_axes_dim)
        latents = self.latents.to(x.dtype)[None].expand(x.shape[0], *self.latents.shape)
        for attn, ff in zip(self.attn_layers, self.ff_layers):
            latents = attn(x, latents, cos_sin) + latents
            latents = ff(latents) + latents
        return _normed(self.norm, latents, self.dtype)
