"""NN primitives (port of diffulab_tpu/networks/nn.py).

Layouts follow the reference: NHWC images, ``[B, S, H, D]`` attention heads.
The precision policy is explicit rather than autocast: every module takes a
compute ``dtype`` (None = promote the input with the fp32 parameters, as
``nnx.Linear`` does) and norms always compute in fp32. The reference's
``stable_conditioning_scope`` global becomes the ``enabled`` argument of
:func:`stable_dtype`, passed down by the model constructor.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def stable_dtype(dtype: torch.dtype | None, enabled: bool = True) -> torch.dtype | None:
    """Compute dtype of the conditioning path (nn.py:57-75): half dtypes
    promote to fp32 so time/label embedding, modulation and the final
    projection stay fp32 under mixed precision. ``enabled=False`` is the
    reference's ``stable_conditioning=False`` whole-model cast."""
    if not enabled:
        return dtype
    if dtype is not None and dtype.is_floating_point and torch.finfo(dtype).bits < 32:
        return torch.float32
    return dtype


class Linear(nn.Module):
    """``nnx.Linear`` semantics: input, weight and bias are cast to ``dtype``
    (or, with ``dtype=None``, promoted to their common type) before the
    product, whose output keeps that type (or ``out_dtype``, the reference's
    ``preferred_element_type``). The weight is stored ``[out, in]`` as torch
    does; :mod:`diffulab_tpu_torch.weights` transposes JAX kernels."""

    def __init__(self, din: int, dout: int, bias: bool = True, *, dtype=None,
                 zero_init: bool = False, device=None, param_dtype=torch.float32, out_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.empty(dout, din, device=device, dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(dout, device=device, dtype=param_dtype))
                     if bias else None)
        if zero_init:
            nn.init.zeros_(self.weight)
        else:
            nn.init.xavier_uniform_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        if self.out_dtype is not None:
            out = F.linear(x.to(dt).to(self.out_dtype), self.weight.to(dt).to(self.out_dtype))
            return out if bias is None else out + bias.to(self.out_dtype)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Module):
    """``nnx.Conv`` on NHWC input: ``weight`` OIHW (torch's layout; the
    bridge transposes JAX's HWIO kernels), ``bias``; ``padding`` is an int
    (symmetric) or ``((top, bottom), (left, right))``; ``groups`` as
    ``feature_group_count``. ``dtype`` as in
    :class:`Linear`. An NHWC tensor permuted to NCHW is a channels-last view,
    which cuDNN convolves without a copy, and the result permutes back to
    NHWC the same way."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int | tuple[tuple[int, int], tuple[int, int]] = 0, *, bias: bool = True,
                 groups: int = 1, zero_init: bool = False, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel_size, kernel_size,
                                               device=device, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(cout, device=device, dtype=param_dtype)) if bias else None
        if zero_init:
            nn.init.zeros_(self.weight)
        else:  # nnx.Conv's default kernel init: lecun normal
            nn.init.normal_(self.weight, std=(cin // groups * kernel_size * kernel_size) ** -0.5)

    def conv(self, x: torch.Tensor, pad) -> torch.Tensor:
        """The convolution of NHWC ``x`` with ``pad`` (as ``padding``)."""
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        x = x.to(dt).permute(0, 3, 1, 2)
        bias = None if self.bias is None else self.bias.to(dt)
        if isinstance(pad, int):
            out = F.conv2d(x, self.weight.to(dt), bias, self.stride, pad, groups=self.groups)
        else:
            (top, bottom), (left, right) = pad
            out = F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight.to(dt), bias, self.stride,
                           groups=self.groups)
        return out.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.padding)


def zero_linear(din: int, dout: int, *, dtype=None, device=None, param_dtype=torch.float32) -> Linear:
    """Zero-initialised Linear (nn.py:524, the reference's ``zero_module``)."""
    return Linear(din, dout, dtype=dtype, zero_init=True, device=device, param_dtype=param_dtype,
                  **accum_dtype_kwargs(dtype))


def zero_conv(cin: int, cout: int, kernel: int, *, dtype=None, device=None, param_dtype=torch.float32) -> Conv2d:
    """Zero-initialised 'same' conv (nn.py:533), as guided-diffusion's out convs."""
    return Conv2d(cin, cout, kernel, padding=kernel // 2, zero_init=True, dtype=dtype, device=device,
                  param_dtype=param_dtype)


#: the reference's opt-in switch for fp32 matmul outputs under a half compute
#: dtype (nn.py:79); off there by default, and so here
ACCUM_FP32 = False


def accum_dtype_kwargs(dtype: torch.dtype | None) -> dict:
    """Matmul constructor kwargs that keep an fp32 output under a half
    compute dtype (nn.py:87): ``{"out_dtype": torch.float32}`` when
    :data:`ACCUM_FP32` is on, else nothing."""
    if ACCUM_FP32 and dtype is not None and dtype.is_floating_point and torch.finfo(dtype).bits < 32:
        return {"out_dtype": torch.float32}
    return {}


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10_000) -> torch.Tensor:
    """Sinusoidal timestep embeddings, [B] -> [B, dim], fp32 (nn.py:102):
    cos block then sin block, zero-padded if dim is odd."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample, NHWC, as broadcast + reshape (nn.py:117)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)


class GroupNorm(nn.Module):
    """``nnx.GroupNorm`` on channels-last input ``[B, ..., C]``: statistics
    over the spatial axes and the channels of each group, in fp32, with the
    fast variance ``E[x²] - E[x]²`` clipped at 0 as flax computes it; the
    output in the promoted dtype of the input and the parameters. The
    parameters keep nnx's names, ``scale`` and ``bias``."""

    def __init__(self, num_features: int, num_groups: int | None = None, eps: float = 1e-6, *,
                 dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        self.num_groups = min(32, num_features) if num_groups is None else num_groups
        if num_features % self.num_groups:
            raise ValueError(f"{num_features} channels do not split into {self.num_groups} groups")
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(num_features, device=device, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.scale.dtype)
        b, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        xf = x.to(torch.promote_types(dt, torch.float32))
        grouped = xf.reshape(b, -1, g, c // g)
        mean = grouped.mean(dim=(1, 3))
        var = torch.clamp(grouped.square().mean(dim=(1, 3)) - mean.square(), min=0.0)
        stat_shape = (b,) + (1,) * (x.ndim - 2) + (c,)
        mean = mean.repeat_interleave(c // g, dim=1).reshape(stat_shape)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(c // g, dim=1).reshape(stat_shape)
        mul = mul * self.scale.to(mul.dtype)
        y = (xf - mean) * mul + self.bias.to(mul.dtype)
        return y.to(dt)


class GroupNorm32(nn.Module):
    """GroupNorm computed in fp32 (nn.py:282), NHWC: ``min(num_groups, C)``
    groups, eps 1e-5, the output cast back to the input dtype. The
    parameters sit in ``norm`` (``norm.scale``, ``norm.bias``), as the
    reference's do."""

    def __init__(self, num_groups: int, channels: int, *, device=None, param_dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm(channels, min(num_groups, channels), eps=1e-5, dtype=torch.float32,
                              device=device, param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x.float()).to(x.dtype)


def normalization(channels: int, *, device=None) -> GroupNorm32:
    """The standard 32-group normalization layer (nn.py:300)."""
    return GroupNorm32(32, channels, device=device)


class Upsample(nn.Module):
    """2x nearest-neighbour upsample with an optional 3x3 conv, NHWC (nn.py:334)."""

    def __init__(self, channels: int, use_conv: bool, out_channels: int | None = None, *,
                 dtype=torch.float32, device=None, param_dtype=torch.float32):
        super().__init__()
        self.channels = channels
        self.out_channels = out_channels or channels
        self.use_conv = use_conv
        if use_conv:
            self.conv = Conv2d(channels, self.out_channels, 3, padding=1, dtype=dtype, device=device,
                               param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.channels:
            raise ValueError(f"Upsample of {self.channels} channels got {x.shape[-1]}")
        x = nearest_upsample_2x(x)
        return self.conv(x) if self.use_conv else x


class Downsample(nn.Module):
    """2x downsample by a stride-2 3x3 conv (padding 1) or a 2x2 average
    pool, NHWC (nn.py:365)."""

    def __init__(self, channels: int, use_conv: bool, out_channels: int | None = None, *,
                 dtype=torch.float32, device=None, param_dtype=torch.float32):
        super().__init__()
        self.channels = channels
        self.out_channels = out_channels or channels
        self.use_conv = use_conv
        if use_conv:
            self.op = Conv2d(channels, self.out_channels, 3, stride=2, padding=1, dtype=dtype, device=device,
                             param_dtype=param_dtype)
        elif self.channels != self.out_channels:
            raise ValueError("an average-pool Downsample keeps its channels")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.channels:
            raise ValueError(f"Downsample of {self.channels} channels got {x.shape[-1]}")
        if self.use_conv:
            return self.op(x)
        b, h, w, c = x.shape
        return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """adaLN modulation ``x * (1 + scale) + shift`` (nn.py:130)."""
    return x * (1 + scale) + shift


def packed_swiglu(x: torch.Tensor) -> torch.Tensor:
    """SwiGLU over a packed [..., 2*dim] tensor (nn.py:135)."""
    x1, x3 = x.chunk(2, dim=-1)
    return F.silu(x1) * x3


def geglu(x: torch.Tensor) -> torch.Tensor:
    """GEGLU over a packed [..., 2*dim] tensor (nn.py:141), with the tanh
    GELU that ``jax.nn.gelu`` defaults to (trap T2)."""
    x1, gate = x.chunk(2, dim=-1)
    return x1 * F.gelu(gate, approximate="tanh")


def get_cos_sin_ndim_grid(
    pos_id: torch.Tensor, base: float, axes_dim: Sequence[int]
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin for N-D grid positions (nn.py:179).

    pos_id: [B, S, n_axes] integer positions; returns [B, S, sum(axes_dim)/2] fp32.
    """
    if len(axes_dim) != pos_id.shape[-1]:
        raise ValueError("axes_dim length must match pos_id n_axes")
    cos_chunks, sin_chunks = [], []
    for axis_idx, axis_dim in enumerate(axes_dim):
        pos_i = pos_id[..., axis_idx].float()
        exponent = torch.arange(0, axis_dim, 2, dtype=torch.float32, device=pos_id.device) / axis_dim
        freqs = 1.0 / (base ** exponent)
        angles = pos_i[..., None] * freqs
        cos_chunks.append(torch.cos(angles))
        sin_chunks.append(torch.sin(angles))
    return torch.cat(cos_chunks, dim=-1), torch.cat(sin_chunks, dim=-1)


def apply_rope_ndim_planar(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, rotary_dim: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate-half N-D RoPE on planar-permuted channels (nn.py:251).

    q/k: [B, S, H, D]; cos/sin: [B, S, rotary_dim/2], cast to q/k's dtype
    before the multiply as the reference does.
    """
    half = rotary_dim // 2

    def rot(x: torch.Tensor) -> torch.Tensor:
        x1 = x[..., :half]
        x2 = x[..., half:rotary_dim]
        x_pass = x[..., rotary_dim:]
        c = cos[:, :, None, :].to(x.dtype)
        s = sin[:, :, None, :].to(x.dtype)
        return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c, x_pass], dim=-1)

    return rot(q), rot(k)


class RMSNorm(nn.Module):
    """RMSNorm with fp32 statistics (nn.py:304); ``x * rrms`` is rounded to
    the input dtype before the scale, as in the reference."""

    def __init__(self, dim: int, *, device=None, param_dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        rrms = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + 1e-6)
        return (xf * rrms).to(x.dtype) * self.scale.to(x.dtype)


class QKNorm(nn.Module):
    """Separate RMSNorms for query/key (nn.py:318), cast to v's dtype."""

    def __init__(self, dim: int, *, device=None, param_dtype=torch.float32):
        super().__init__()
        self.query_norm = RMSNorm(dim, device=device, param_dtype=param_dtype)
        self.key_norm = RMSNorm(dim, device=device, param_dtype=param_dtype)

    def forward(self, q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
        return self.query_norm(q).to(v.dtype), self.key_norm(k).to(v.dtype)


class LabelEmbed(nn.Module):
    """Class-label embedding with a CFG null class (nn.py:401); ``drop`` is a
    per-sample bool mask that swaps the label for the null class."""

    def __init__(self, num_classes: int, embed_dim: int, classifier_free_guidance: bool = False,
                 *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.classifier_free_guidance = classifier_free_guidance
        self.dtype = dtype
        n_embed = num_classes + 1 if classifier_free_guidance else num_classes
        self.embedding = nn.Embedding(n_embed, embed_dim, device=device, dtype=param_dtype)
        nn.init.normal_(self.embedding.weight, std=embed_dim ** -0.5)

    def forward(self, labels: torch.Tensor, drop: torch.Tensor | None = None) -> torch.Tensor:
        if drop is not None:
            if not self.classifier_free_guidance:
                raise ValueError("Label dropout is only supported with classifier-free guidance.")
            labels = torch.where(drop, self.num_classes, labels)
        out = self.embedding(labels)
        return out.to(self.dtype) if self.dtype is not None else out


def make_drop_mask(generator: torch.Generator, p: float, batch_size: int,
                   device: str | torch.device | None = None) -> torch.Tensor:
    """Per-sample CFG condition-drop mask, True with probability ``p``
    (nn.py:441), drawn with ``generator`` on ``device`` (default: the
    generator's device)."""
    device = generator.device if device is None else device
    return torch.rand((batch_size,), generator=generator, device=device) < p


class TimestepEmbedder(nn.Module):
    """Sinusoidal embedding + 2-layer SiLU MLP (nn.py:449); the conditioning
    path, so fp32 under a half ``dtype``."""

    def __init__(self, hidden_dim: int, frequency_dim: int = 256, *, dtype=None, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.frequency_dim = frequency_dim
        dtype = stable_dtype(dtype)
        self.fc1 = Linear(frequency_dim, hidden_dim, dtype=dtype, device=device, param_dtype=param_dtype)
        self.fc2 = Linear(hidden_dim, hidden_dim, dtype=dtype, device=device, param_dtype=param_dtype)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(timesteps, self.frequency_dim).to(self.fc1.weight.dtype)
        return self.fc2(F.silu(self.fc1(emb)))


class ModulationOut:
    """Six-way adaLN modulation parameters (nn.py:473)."""

    __slots__ = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")

    def __init__(self, alpha, beta, gamma, delta, epsilon, zeta):
        self.alpha = alpha
        self.beta = beta
        self.gamma = gamma
        self.delta = delta
        self.epsilon = epsilon
        self.zeta = zeta


class Modulation(nn.Module):
    """silu + linear producing ``n_chunks`` adaLN chunks (nn.py:487);
    zero-initialised (adaLN-zero) by default."""

    def __init__(self, embedding_dim: int, input_dim: int, n_chunks: int = 6, zero_init: bool = True,
                 *, dtype=None, device=None, param_dtype=torch.float32):
        super().__init__()
        self.n_chunks = n_chunks
        self.lin = Linear(embedding_dim, n_chunks * input_dim, dtype=dtype, zero_init=zero_init,
                          device=device, param_dtype=param_dtype)

    def forward(self, vec: torch.Tensor):
        out = self.lin(F.silu(vec))
        if out.ndim == 2:
            out = out[:, None, :]
        chunks = out.chunk(self.n_chunks, dim=-1)
        if self.n_chunks == 6:
            return ModulationOut(*chunks)
        return chunks
