"""SD/Flux-family convolutional KL-VAE (port of
diffulab_tpu/networks/vision_towers/vae.py), NHWC at every module boundary.

GroupNorm-SiLU-conv residual blocks, single-head mid attention, strided-conv
downsampling, nearest-upsample + conv decoding: the architecture that
diffusers' ``AutoencoderKL`` family, the Flux VAEs included, instantiates.
:func:`load_autoencoder_kl_state_dict` maps a diffusers checkpoint, given as
numpy arrays, onto these modules.

Convolutions (:class:`~diffulab_tpu_torch.networks.nn.Conv2d`) keep the JAX
package's NHWC layout at their boundaries. The mid
attention is plain einsum + softmax in the JAX package (vae.py:53-61), not a
Pallas kernel, so it stays ``torch.matmul`` here; it runs one image at a
time, since at 128x128 latents its fp32 score matrix is 1 GiB an image.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffulab_tpu_torch import jax_prng
from diffulab_tpu_torch.networks.nn import Conv2d, GroupNorm, Linear, nearest_upsample_2x


class VAEResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.norm1 = GroupNorm(cin, **kw)
        self.conv1 = Conv2d(cin, cout, 3, padding=1, **kw)
        self.norm2 = GroupNorm(cout, **kw)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, **kw)
        self.shortcut = Conv2d(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        skip = self.shortcut(x) if self.shortcut is not None else x
        return skip + h


class VAEAttnBlock(nn.Module):
    """Single-head full attention over spatial tokens (VAE mid block)."""

    def __init__(self, channels: int, *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.norm = GroupNorm(channels, **kw)
        self.to_q = Linear(channels, channels, **kw)
        self.to_k = Linear(channels, channels, **kw)
        self.to_v = Linear(channels, channels, **kw)
        self.to_out = Linear(channels, channels, **kw)
        self.scale = channels ** -0.5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h_, w_, c = x.shape
        tokens = self.norm(x).reshape(b, h_ * w_, c)
        q, k, v = self.to_q(tokens), self.to_k(tokens), self.to_v(tokens)
        out = []
        for i in range(b):  # one image at a time: the scores are [HW, HW]
            attn = torch.softmax(torch.matmul(q[i], k[i].transpose(0, 1)).float() * self.scale, dim=-1)
            out.append(torch.matmul(attn.to(v.dtype), v[i]))
        out = self.to_out(torch.stack(out))
        return x + out.reshape(b, h_, w_, c)


class VAEEncoder(nn.Module):
    def __init__(self, in_channels: int = 3, base_channels: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 z_channels: int = 16, double_z: bool = True, mid_attention: bool = True,
                 *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.conv_in = Conv2d(in_channels, base_channels, 3, padding=1, **kw)
        down_blocks = []
        downsamplers = {}
        ch = base_channels
        for level, mult in enumerate(ch_mult):
            cout = base_channels * mult
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(VAEResnetBlock(ch, cout, **kw))
                ch = cout
            down_blocks.append(nn.ModuleList(blocks))
            if level != len(ch_mult) - 1:
                downsamplers[str(level)] = Conv2d(ch, ch, 3, stride=2, padding=((0, 1), (0, 1)), **kw)
        self.down_blocks = nn.ModuleList(down_blocks)
        # keyed by level, so the parameter names match the reference's list
        # (whose last entry is None)
        self.downsamplers = nn.ModuleDict(downsamplers)
        self.mid_res1 = VAEResnetBlock(ch, ch, **kw)
        self.mid_attn = VAEAttnBlock(ch, **kw) if mid_attention else None
        self.mid_res2 = VAEResnetBlock(ch, ch, **kw)
        self.norm_out = GroupNorm(ch, **kw)
        self.conv_out = Conv2d(ch, 2 * z_channels if double_z else z_channels, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level, blocks in enumerate(self.down_blocks):
            for block in blocks:
                h = block(h)
            if str(level) in self.downsamplers:
                h = self.downsamplers[str(level)](h)
        h = self.mid_res1(h)
        if self.mid_attn is not None:
            h = self.mid_attn(h)
        h = self.mid_res2(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VAEDecoder(nn.Module):
    def __init__(self, out_channels: int = 3, base_channels: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 z_channels: int = 16, mid_attention: bool = True,
                 *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        ch = base_channels * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, ch, 3, padding=1, **kw)
        self.mid_res1 = VAEResnetBlock(ch, ch, **kw)
        self.mid_attn = VAEAttnBlock(ch, **kw) if mid_attention else None
        self.mid_res2 = VAEResnetBlock(ch, ch, **kw)
        up_blocks = []
        upsamplers = {}
        for level, mult in enumerate(reversed(ch_mult)):
            cout = base_channels * mult
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(VAEResnetBlock(ch, cout, **kw))
                ch = cout
            up_blocks.append(nn.ModuleList(blocks))
            if level != len(ch_mult) - 1:
                upsamplers[str(level)] = Conv2d(ch, ch, 3, padding=1, **kw)
        self.up_blocks = nn.ModuleList(up_blocks)
        self.upsamplers = nn.ModuleDict(upsamplers)
        self.norm_out = GroupNorm(ch, **kw)
        self.conv_out = Conv2d(ch, out_channels, 3, padding=1, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid_res1(h)
        if self.mid_attn is not None:
            h = self.mid_attn(h)
        h = self.mid_res2(h)
        for level, blocks in enumerate(self.up_blocks):
            for block in blocks:
                h = block(h)
            if str(level) in self.upsamplers:
                h = self.upsamplers[str(level)](nearest_upsample_2x(h))
        return self.conv_out(F.silu(self.norm_out(h)))


def diagonal_gaussian_sample(moments: torch.Tensor, generator: torch.Generator | np.ndarray | None) -> torch.Tensor:
    """Sample (or take the mean when ``generator`` is None) from encoder
    moments ``[..., 2*z]``: first half mean, second half logvar (diffusers
    convention). The noise is drawn with a torch ``generator`` on its
    device, or, when ``generator`` is a JAX PRNG key (two uint32 words), as
    ``jax.random.normal(key, mean.shape)`` draws it (:mod:`...jax_prng`)."""
    mean, logvar = moments.chunk(2, dim=-1)
    if generator is None:
        return mean
    logvar = torch.clamp(logvar, -30.0, 20.0)
    std = torch.exp(0.5 * logvar)
    if isinstance(generator, np.ndarray):
        noise = torch.as_tensor(jax_prng.normal(generator, tuple(mean.shape)), dtype=mean.dtype)
    else:
        noise = torch.randn(mean.shape, generator=generator, device=generator.device, dtype=mean.dtype)
    return mean + std * noise.to(mean.device)


# --------------------------------------------------------------------------- #
# diffusers AutoencoderKL weight porting
# --------------------------------------------------------------------------- #


def _put(param: torch.Tensor, value) -> None:
    value = np.asarray(value)
    if tuple(param.shape) != value.shape:
        raise ValueError(f"shape {tuple(param.shape)} vs {value.shape}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.ascontiguousarray(value)).to(param.dtype))


def _port_conv(conv: Conv2d, sd: dict, prefix: str) -> None:
    _put(conv.weight, sd[prefix + ".weight"])  # diffusers stores OIHW, as the port does
    _put(conv.bias, sd[prefix + ".bias"])


def _port_gn(norm: GroupNorm, sd: dict, prefix: str) -> None:
    _put(norm.scale, sd[prefix + ".weight"])
    _put(norm.bias, sd[prefix + ".bias"])


def _port_resnet(block: VAEResnetBlock, sd: dict, prefix: str) -> None:
    _port_gn(block.norm1, sd, prefix + ".norm1")
    _port_conv(block.conv1, sd, prefix + ".conv1")
    _port_gn(block.norm2, sd, prefix + ".norm2")
    _port_conv(block.conv2, sd, prefix + ".conv2")
    if block.shortcut is not None:
        _port_conv(block.shortcut, sd, prefix + ".conv_shortcut")


def _port_attn(attn: VAEAttnBlock, sd: dict, prefix: str) -> None:
    _port_gn(attn.norm, sd, prefix + ".group_norm")
    for name, lin in (("to_q", attn.to_q), ("to_k", attn.to_k), ("to_v", attn.to_v)):
        _put(lin.weight, sd[f"{prefix}.{name}.weight"])
        _put(lin.bias, sd[f"{prefix}.{name}.bias"])
    _put(attn.to_out.weight, sd[prefix + ".to_out.0.weight"])
    _put(attn.to_out.bias, sd[prefix + ".to_out.0.bias"])


def load_autoencoder_kl_state_dict(encoder: VAEEncoder, decoder: VAEDecoder,
                                   sd: dict[str, np.ndarray]) -> None:
    """Port a diffusers AutoencoderKL state dict (numpy arrays) onto
    VAEEncoder/VAEDecoder (vae.py:222). quant/post_quant convs, when
    present, must be identity (Flux-family VAEs have none)."""
    _port_conv(encoder.conv_in, sd, "encoder.conv_in")
    for i, blocks in enumerate(encoder.down_blocks):
        for j, block in enumerate(blocks):
            _port_resnet(block, sd, f"encoder.down_blocks.{i}.resnets.{j}")
        if str(i) in encoder.downsamplers:
            _port_conv(encoder.downsamplers[str(i)], sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")
    _port_resnet(encoder.mid_res1, sd, "encoder.mid_block.resnets.0")
    if encoder.mid_attn is not None:
        _port_attn(encoder.mid_attn, sd, "encoder.mid_block.attentions.0")
    _port_resnet(encoder.mid_res2, sd, "encoder.mid_block.resnets.1")
    _port_gn(encoder.norm_out, sd, "encoder.conv_norm_out")
    _port_conv(encoder.conv_out, sd, "encoder.conv_out")

    _port_conv(decoder.conv_in, sd, "decoder.conv_in")
    _port_resnet(decoder.mid_res1, sd, "decoder.mid_block.resnets.0")
    if decoder.mid_attn is not None:
        _port_attn(decoder.mid_attn, sd, "decoder.mid_block.attentions.0")
    _port_resnet(decoder.mid_res2, sd, "decoder.mid_block.resnets.1")
    for i, blocks in enumerate(decoder.up_blocks):
        for j, block in enumerate(blocks):
            _port_resnet(block, sd, f"decoder.up_blocks.{i}.resnets.{j}")
        if str(i) in decoder.upsamplers:
            _port_conv(decoder.upsamplers[str(i)], sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")
    _port_gn(decoder.norm_out, sd, "decoder.conv_norm_out")
    _port_conv(decoder.conv_out, sd, "decoder.conv_out")
