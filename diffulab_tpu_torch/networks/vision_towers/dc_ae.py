"""DC-AE tower (port of diffulab_tpu/networks/vision_towers/dc_ae.py;
reference src/diffulab/networks/vision_towers/dc_ae.py:8-84).

The deep-compression autoencoder (DC-AE, arXiv:2410.10733) of diffusers'
``AutoencoderDC`` ("mit-han-lab/dc-ae-f32c32-in-1.0-diffusers"), NHWC:

* residual autoencoding: every down/upsample and the latent projection
  carries a parameter-free space-to-channel shortcut (pixel-unshuffle and
  channel-group averaging down, channel duplication and pixel-shuffle up);
* EfficientViT stages at low resolution: LiteMLA (ReLU linear attention in
  fp32, with multi-scale depthwise-conv token aggregation) and GLUMBConv,
  both RMS-normalised and residual; conv ResBlocks at high resolution;
* a deterministic latent from inputs normalised to [-1, 1], scaled by
  ``scaling_factor``.

The defaults give f32c32 (6 stages, 5 downsamples, 32 latent channels,
scaling factor 0.41407). :func:`load_dc_ae_state_dict` loads a diffusers
``AutoencoderDC`` state dict (numpy arrays, torch layouts).

Every conv pads as flax's ``padding="SAME"`` (dc_ae.py:51): a stride-2 conv
on an even input pads 0 before and 1 after (trap T26), where
``nn.Conv2d(padding=1)`` would pad 1 on each side and shift the output by
a pixel. :func:`_space_to_depth` and :func:`_depth_to_space` keep the JAX
package's NHWC channel order (``ch = c * 4 + subpixel``).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffulab_tpu_torch.networks.nn import Conv2d, Linear, nearest_upsample_2x
from diffulab_tpu_torch.networks.vision_towers.common import VisionTower, normalize_to_pm1
from diffulab_tpu_torch.utils import resolve_device
from diffulab_tpu_torch.weights import copy_checked_

_F32C32_CHANNELS = (128, 256, 512, 512, 1024, 1024)
_F32C32_TYPES = ("res", "res", "res", "vit", "vit", "vit")
_F32C32_ENC_LAYERS = (2, 2, 2, 3, 3, 3)
_F32C32_DEC_LAYERS = (3, 3, 3, 3, 3, 3)
_F32C32_MULTISCALES: tuple[tuple[int, ...], ...] = ((), (), (), (5,), (5,), (5,))


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax's ``padding="SAME"`` along one axis: the output has
    ceil(size / stride) positions, the padding that needs split with the
    smaller half before."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(Conv2d):
    """:class:`Conv2d` padded as flax's ``"SAME"`` for the input it is given (T26)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        top, bottom = same_padding(x.shape[1], k, self.stride)
        left, right = same_padding(x.shape[2], k, self.stride)
        pad = top if top == bottom == left == right else ((top, bottom), (left, right))
        return self.conv(x, pad)


def _conv(cin, cout, k, *, stride=1, use_bias=True, groups=1, device, dtype, param_dtype) -> SameConv2d:
    return SameConv2d(cin, cout, k, stride, bias=use_bias, groups=groups, device=device, dtype=dtype,
                      param_dtype=param_dtype)


class ChannelRMSNorm(nn.Module):
    """Channel-last RMSNorm with a bias, in fp32 (dc_ae.py:57)."""

    def __init__(self, dim: int, *, device=None, param_dtype=torch.float32, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=param_dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + self.eps)
        return (h * self.scale.float() + self.bias.float()).to(x.dtype)


class DCResBlock(nn.Module):
    """conv3x3 -> SiLU -> conv3x3 (no bias) -> RMSNorm, residual (dc_ae.py:72)."""

    def __init__(self, channels: int, **kw: Any):
        super().__init__()
        self.conv1 = _conv(channels, channels, 3, **kw)
        self.conv2 = _conv(channels, channels, 3, use_bias=False, **kw)
        self.norm = ChannelRMSNorm(channels, device=kw["device"], param_dtype=kw["param_dtype"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv2(F.silu(self.conv1(x)))) + x


class GLUMBConv(nn.Module):
    """1x1 expand to 2 * mult * C -> SiLU -> 3x3 depthwise -> GLU gate -> 1x1
    project (no bias) -> RMSNorm, residual (dc_ae.py:87)."""

    def __init__(self, channels: int, mult: int = 4, **kw: Any):
        super().__init__()
        hidden = channels * mult
        self.conv_inverted = _conv(channels, hidden * 2, 1, **kw)
        self.conv_depth = _conv(hidden * 2, hidden * 2, 3, groups=hidden * 2, **kw)
        self.conv_point = _conv(hidden, channels, 1, use_bias=False, **kw)
        self.norm = ChannelRMSNorm(channels, device=kw["device"], param_dtype=kw["param_dtype"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_depth(F.silu(self.conv_inverted(x)))
        h, gate = h.chunk(2, dim=-1)
        return self.norm(self.conv_point(h * F.silu(gate))) + x


class LiteMLA(nn.Module):
    """Multi-scale ReLU linear attention (dc_ae.py:108): q, k, v from
    bias-free linears, extra scales from depthwise convs over the packed
    qkv, per head out = relu(q) (relu(k)^T v) / (relu(q) relu(k)^T 1 + eps),
    in fp32."""

    def __init__(self, channels: int, head_dim: int = 8, multiscales: Sequence[int] = (5,), **kw: Any):
        super().__init__()
        if channels % head_dim:
            raise ValueError(f"{channels} channels do not split into heads of {head_dim}")
        lin = dict(bias=False, device=kw["device"], dtype=kw["dtype"], param_dtype=kw["param_dtype"])
        self.to_q = Linear(channels, channels, **lin)
        self.to_k = Linear(channels, channels, **lin)
        self.to_v = Linear(channels, channels, **lin)
        self.to_qkv_multiscale = nn.ModuleList([_conv(3 * channels, 3 * channels, k, groups=3 * channels, **kw)
                                                for k in multiscales])
        self.to_out = Linear(channels * (1 + len(multiscales)), channels, **lin)
        self.norm_out = ChannelRMSNorm(channels, device=kw["device"], param_dtype=kw["param_dtype"])
        self.head_dim = head_dim
        self.eps = 1e-15

    def _attend(self, qkv: torch.Tensor) -> torch.Tensor:
        """qkv ``[B, H, W, 3C]`` -> the linear attention's ``[B, H, W, C]`` in fp32."""
        b, h, w, _ = qkv.shape
        q, k, v = qkv.reshape(b, h * w, -1).chunk(3, dim=-1)
        d = self.head_dim
        # fp32: the ReLU kernel's normalisers underflow in bf16
        q = F.relu(q).reshape(b, h * w, -1, d).float()
        k = F.relu(k).reshape(b, h * w, -1, d).float()
        v = v.reshape(b, h * w, -1, d).float()
        kv = torch.einsum("bshd,bshe->bhde", k, v)
        num = torch.einsum("bshd,bhde->bshe", q, kv)
        den = torch.einsum("bshd,bhd->bsh", q, k.sum(dim=1))[..., None] + self.eps
        return (num / den).reshape(b, h, w, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = torch.cat([self.to_q(x), self.to_k(x), self.to_v(x)], dim=-1)
        outs = [self._attend(qkv)] + [self._attend(conv(qkv)) for conv in self.to_qkv_multiscale]
        out = self.to_out(torch.cat(outs, dim=-1).to(x.dtype))
        return self.norm_out(out) + x


class EfficientViTBlock(nn.Module):
    """LiteMLA then GLUMBConv, both residual (dc_ae.py:156)."""

    def __init__(self, channels: int, head_dim: int = 8, multiscales: Sequence[int] = (5,), **kw: Any):
        super().__init__()
        self.attn = LiteMLA(channels, head_dim, multiscales, **kw)
        self.conv_out = GLUMBConv(channels, 4, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.attn(x))


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC pixel-unshuffle(2), channel order ch = c * 4 + subpixel (dc_ae.py:175)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)  # [B, H/2, W/2, C, 2, 2]
    return x.reshape(b, h // 2, w // 2, c * 4)


def _depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """NHWC pixel-shuffle(2), the inverse order of :func:`_space_to_depth` (dc_ae.py:183)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, c // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)  # [B, H, 2, W, 2, C/4]
    return x.reshape(b, h * 2, w * 2, c // 4)


def _channel_group_mean(x: torch.Tensor, cout: int) -> torch.Tensor:
    """Average consecutive channel groups down to ``cout`` channels."""
    cin = x.shape[-1]
    if cin % cout:
        raise ValueError(f"cannot group {cin} channels into {cout}")
    return x.reshape(*x.shape[:-1], cout, cin // cout).mean(dim=-1)


class DCDownBlock(nn.Module):
    """Stride-2 conv (SAME, T26) and the space-to-channel shortcut (dc_ae.py:199)."""

    def __init__(self, cin: int, cout: int, **kw: Any):
        super().__init__()
        self.conv = _conv(cin, cout, 3, stride=2, **kw)
        self.cout = cout
        # the shortcut needs 4 * cin to group-average into cout; other (tiny) geometries drop it
        self.shortcut = (4 * cin) % cout == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        return h + _channel_group_mean(_space_to_depth(x), self.cout) if self.shortcut else h


class DCUpBlock(nn.Module):
    """Upsample and the channel-duplication shortcut (dc_ae.py:218):
    ``pixel_shuffle`` convs to 4 * cout then depth-to-space, with the
    shortcut; ``interpolate`` is nearest x2 then a conv, no shortcut."""

    def __init__(self, cin: int, cout: int, mode: str = "pixel_shuffle", **kw: Any):
        super().__init__()
        if mode not in ("pixel_shuffle", "interpolate"):
            raise ValueError(f"unknown upsample mode {mode!r}")
        self.mode = mode
        self.cin, self.cout = cin, cout
        self.conv = _conv(cin, cout * 4 if mode == "pixel_shuffle" else cout, 3, **kw)
        self.shortcut = mode == "pixel_shuffle" and (4 * cout) % cin == 0 and 4 * cout >= cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "interpolate":
            return self.conv(nearest_upsample_2x(x))
        h = _depth_to_space(self.conv(x))
        if not self.shortcut:
            return h
        return h + _depth_to_space(torch.repeat_interleave(x, (4 * self.cout) // self.cin, dim=-1))


def _stage_blocks(ch: int, block_type: str, layers: int, head_dim: int, multiscales, **kw: Any) -> list[nn.Module]:
    if block_type == "res":
        return [DCResBlock(ch, **kw) for _ in range(layers)]
    return [EfficientViTBlock(ch, head_dim, multiscales, **kw) for _ in range(layers)]


class DCAEEncoder(nn.Module):
    """conv_in -> [down, blocks...] a stage -> conv_out plus the group-mean
    latent shortcut (dc_ae.py:244)."""

    def __init__(self, in_channels, channels, block_types, layers_per_block, latent_channels, multiscales, head_dim,
                 **kw: Any):
        super().__init__()
        self.conv_in = _conv(in_channels, channels[0], 3, **kw)
        stages = []
        for i, ch in enumerate(channels):
            stage = [DCDownBlock(channels[i - 1], ch, **kw)] if i > 0 else []
            stage += _stage_blocks(ch, block_types[i], layers_per_block[i], head_dim, multiscales[i], **kw)
            stages.append(nn.ModuleList(stage))
        self.down_blocks = nn.ModuleList(stages)
        self.conv_out = _conv(channels[-1], latent_channels, 3, **kw)
        self.latent_channels = latent_channels
        self.out_shortcut = channels[-1] % latent_channels == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for stage in self.down_blocks:
            for block in stage:
                x = block(x)
        h = self.conv_out(x)
        return h + _channel_group_mean(x, self.latent_channels) if self.out_shortcut else h


class DCAEDecoder(nn.Module):
    """conv_in plus the channel-repeat latent shortcut -> [up, blocks...] in
    reversed stages -> RMSNorm -> ReLU -> conv_out (dc_ae.py:279)."""

    def __init__(self, out_channels, channels, block_types, layers_per_block, latent_channels, multiscales, head_dim,
                 upsample_mode="pixel_shuffle", **kw: Any):
        super().__init__()
        self.conv_in = _conv(latent_channels, channels[-1], 3, **kw)
        # the latent-repeat shortcut only when the latent repeats evenly
        self.in_repeats = channels[-1] // latent_channels if channels[-1] % latent_channels == 0 else 0
        stages = []
        n = len(channels)
        for i in reversed(range(n)):
            stage = [DCUpBlock(channels[i + 1], channels[i], upsample_mode, **kw)] if i < n - 1 else []
            stage += _stage_blocks(channels[i], block_types[i], layers_per_block[i], head_dim, multiscales[i], **kw)
            stages.append(nn.ModuleList(stage))
        self.up_blocks = nn.ModuleList(stages)
        self.norm_out = ChannelRMSNorm(channels[0], device=kw["device"], param_dtype=kw["param_dtype"])
        self.conv_out = _conv(channels[0], out_channels, 3, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z)
        if self.in_repeats:
            x = x + torch.repeat_interleave(z, self.in_repeats, dim=-1)
        for stage in self.up_blocks:
            for block in stage:
                x = block(x)
        return self.conv_out(F.relu(self.norm_out(x)))


class DCAE(VisionTower):
    """DC-AE f32c32 vision tower (dc_ae.py:315)."""

    def __init__(
        self,
        block_out_channels: Sequence[int] = _F32C32_CHANNELS,
        block_types: Sequence[str] = _F32C32_TYPES,
        encoder_layers_per_block: Sequence[int] = _F32C32_ENC_LAYERS,
        decoder_layers_per_block: Sequence[int] = _F32C32_DEC_LAYERS,
        latent_channels: int = 32,
        qkv_multiscales: Sequence[Sequence[int]] = _F32C32_MULTISCALES,
        attention_head_dim: int = 8,
        upsample_mode: str = "pixel_shuffle",
        scaling_factor: float = 0.41407,  # dc-ae-f32c32-in-1.0 config
        *,
        dtype: torch.dtype | None = None,
        param_dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(latent_scale=scaling_factor)
        kw = dict(device=resolve_device(device), dtype=dtype, param_dtype=param_dtype)
        args = (tuple(block_out_channels), tuple(block_types))
        multiscales = tuple(tuple(m) for m in qkv_multiscales)
        self.encoder = DCAEEncoder(3, *args, tuple(encoder_layers_per_block), latent_channels, multiscales,
                                   attention_head_dim, **kw)
        self.decoder = DCAEDecoder(3, *args, tuple(decoder_layers_per_block), latent_channels, multiscales,
                                   attention_head_dim, upsample_mode, **kw)
        self._compression_factor = 2 ** (len(block_out_channels) - 1)
        self._latent_channels = latent_channels

    @property
    def compression_factor(self) -> int:
        return self._compression_factor

    @property
    def latent_channels(self) -> int:
        return self._latent_channels

    def encode(self, x: torch.Tensor, generator: Any = None) -> torch.Tensor:
        """NHWC image -> latents; deterministic, ``generator`` unused (dc_ae.py:363)."""
        del generator
        return self.encoder(normalize_to_pm1(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)


# --------------------------------------------------------------------------- #
# diffusers AutoencoderDC checkpoint loading
# --------------------------------------------------------------------------- #


def load_dc_ae_state_dict(model: DCAE, sd: dict[str, np.ndarray]) -> None:
    """Load a diffusers ``AutoencoderDC`` state dict into :class:`DCAE`
    (dc_ae.py:379): ``{enc,dec}oder.conv_in/conv_out``,
    ``encoder.down_blocks.{s}.{j}.…`` / ``decoder.up_blocks.{s}.{j}.…``
    (``j`` over [the down/up-sampler where there is one] + blocks); a
    ResBlock's ``conv1/conv2/norm``, an EfficientViTBlock's
    ``attn.{to_q,to_k,to_v,to_qkv_multiscale.{m}.proj,to_out,norm_out}`` and
    ``conv_out.{conv_inverted,conv_depth,conv_point,norm}``. The layouts are
    torch's on both sides; a missing key, a shape mismatch or a key left
    over raises."""
    used: set[str] = set()

    def put(param: torch.Tensor, key: str) -> None:
        if key not in sd:
            raise KeyError(f"missing checkpoint key: {key}")
        used.add(key)
        copy_checked_(param, sd[key], key)

    def set_layer(mod: nn.Module, prefix: str) -> None:  # a conv or a linear
        put(mod.weight, prefix + ".weight")
        if mod.bias is not None:
            put(mod.bias, prefix + ".bias")

    def set_norm(mod: ChannelRMSNorm, prefix: str) -> None:
        put(mod.scale, prefix + ".weight")
        if prefix + ".bias" in sd:
            put(mod.bias, prefix + ".bias")

    def set_block(block: nn.Module, prefix: str) -> None:
        if isinstance(block, DCResBlock):
            set_layer(block.conv1, prefix + ".conv1")
            set_layer(block.conv2, prefix + ".conv2")
            set_norm(block.norm, prefix + ".norm")
        elif isinstance(block, EfficientViTBlock):
            attn, conv = block.attn, block.conv_out
            for name in ("to_q", "to_k", "to_v", "to_out"):
                set_layer(getattr(attn, name), f"{prefix}.attn.{name}")
            for m, ms_conv in enumerate(attn.to_qkv_multiscale):
                set_layer(ms_conv, f"{prefix}.attn.to_qkv_multiscale.{m}.proj")
            set_norm(attn.norm_out, prefix + ".attn.norm_out")
            for name in ("conv_inverted", "conv_depth", "conv_point"):
                set_layer(getattr(conv, name), f"{prefix}.conv_out.{name}")
            set_norm(conv.norm, prefix + ".conv_out.norm")
        elif isinstance(block, (DCDownBlock, DCUpBlock)):
            set_layer(block.conv, prefix + ".conv")
        else:  # pragma: no cover
            raise TypeError(f"unknown block {type(block)} at {prefix}")

    for side, stages_name in (("encoder", "down_blocks"), ("decoder", "up_blocks")):
        half = getattr(model, side)
        set_layer(half.conv_in, f"{side}.conv_in")
        for s, stage in enumerate(getattr(half, stages_name)):
            for j, block in enumerate(stage):
                set_block(block, f"{side}.{stages_name}.{s}.{j}")
        if side == "decoder":
            set_norm(half.norm_out, "decoder.norm_out")
        set_layer(half.conv_out, f"{side}.conv_out")
    unused = sorted(set(sd) - used)
    if unused:
        raise ValueError(f"unmatched checkpoint keys: {unused}")
