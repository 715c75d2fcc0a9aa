"""Trainable byte-level text embedder (port of
diffulab_tpu/networks/embedders/trainable.py).

A small transformer encoder over byte tokens whose parameters live in the
denoiser's ``context_embedder``, so that ``train_embedder=True``
(:func:`~diffulab_tpu_torch.training.checkpoint.trainable_filter`) puts them
in the optimizer and the denoiser's loss trains it. Captions are tokenized
on the host (:func:`byte_tokenize`: ``[BOS, utf-8 bytes + 2, PAD...]``); a
dropped sample encodes the BOS-only empty prompt, so the null conditioning
is learned with the rest (trainable.py:119). Each block is pre-RMSNorm
attention with 1-D rotate-half RoPE and a SwiGLU MLP, bias-free; the
attention goes through :func:`~diffulab_tpu_torch.ops.attention.dot_product_attention`
with the padding mask as its key mask (on the card, K1/K2 at the
``max_len`` tokens padded to 128).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from diffulab_tpu_torch.networks.embedders.common import ContextEmbedder, ContextEmbedderOutput
from diffulab_tpu_torch.networks.nn import Linear, RMSNorm, apply_rope_1d, packed_swiglu, rope_1d_cos_sin
from diffulab_tpu_torch.ops.attention import dot_product_attention
from diffulab_tpu_torch.utils import resolve_device, resolve_dtype

PAD_ID = 0
BOS_ID = 1
BYTE_OFFSET = 2  # token id of byte b is b + 2
VOCAB_SIZE = 256 + BYTE_OFFSET


def byte_tokenize(texts: Sequence[str], max_len: int = 64) -> dict[str, np.ndarray]:
    """Host-side byte tokenizer (trainable.py:43): ``{"token_ids": [B, max_len]
    int32, "attn_mask": [B, max_len] bool}``, BOS then the utf-8 bytes
    (truncated to ``max_len - 1``), PAD after."""
    ids = np.full((len(texts), max_len), PAD_ID, np.int32)
    mask = np.zeros((len(texts), max_len), bool)
    for i, text in enumerate(texts):
        toks = [BOS_ID] + [b + BYTE_OFFSET for b in text.encode("utf-8")[: max_len - 1]]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = True
    return {"token_ids": ids, "attn_mask": mask}


class _EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, *, dtype=None, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.norm1 = RMSNorm(dim, device=device, param_dtype=param_dtype)
        self.qkv = Linear(dim, 3 * dim, bias=False, **kw)
        self.proj = Linear(dim, dim, bias=False, **kw)
        self.norm2 = RMSNorm(dim, device=device, param_dtype=param_dtype)
        hidden = int(dim * mlp_ratio)
        self.mlp_in = Linear(dim, 2 * hidden, bias=False, **kw)
        self.mlp_out = Linear(hidden, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = self.qkv(self.norm1(x).to(x.dtype)).chunk(3, dim=-1)
        q, k = apply_rope_1d(q.reshape(b, n, self.num_heads, self.head_dim),
                             k.reshape(b, n, self.num_heads, self.head_dim), cos, sin, self.head_dim)
        v = v.reshape(b, n, self.num_heads, self.head_dim)
        out = dot_product_attention(q, k, v, kv_mask=mask)
        x = x + self.proj(out.reshape(b, n, d))
        return x + self.mlp_out(packed_swiglu(self.mlp_in(self.norm2(x).to(x.dtype))))


class TrainableTextEmbedder(ContextEmbedder):
    """Byte-level transformer text encoder (trainable.py:88). Context:
    ``{"token_ids": [B, max_len], "attn_mask": [B, max_len]}`` from
    :meth:`tokenize`; output: the token ``embeddings`` [B, max_len, dim] (and
    their masked mean, ``pooled_embeddings``, with ``pooled=True``) and the
    mask, the :class:`PrecomputedEmbedder` surface."""

    def __init__(self, dim: int = 256, depth: int = 4, num_heads: int = 4, mlp_ratio: float = 4.0,
                 max_len: int = 64, pooled: bool = False, vocab_size: int = VOCAB_SIZE, *,
                 dtype=None, param_dtype=torch.float32, device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        dtype, param_dtype = resolve_dtype(dtype), resolve_dtype(param_dtype)
        self.max_len = max_len
        self.tok_embed = nn.Embedding(vocab_size, dim, device=device, dtype=param_dtype)
        nn.init.normal_(self.tok_embed.weight, std=dim ** -0.5)
        self.blocks = nn.ModuleList([
            _EncoderBlock(dim, num_heads, mlp_ratio, dtype=dtype, device=device, param_dtype=param_dtype)
            for _ in range(depth)
        ])
        self.final_norm = RMSNorm(dim, device=device, param_dtype=param_dtype)
        self._head_dim = dim // num_heads
        self.pooled = pooled
        self._n_output = 2 if pooled else 1
        self._output_size = (dim, dim) if pooled else (dim,)

    def tokenize(self, texts: Sequence[str]) -> dict[str, np.ndarray]:
        return byte_tokenize(texts, self.max_len)

    def drop_conditions(self, context: dict[str, torch.Tensor], drop: torch.Tensor) -> dict[str, torch.Tensor]:
        """Dropped rows become the BOS-only empty prompt before encoding."""
        ids = context["token_ids"]
        mask = context.get("attn_mask")
        if mask is None:
            mask = ids != PAD_ID
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        null_ids = torch.where(pos == 0, BOS_ID, PAD_ID).to(ids.dtype)
        ids = torch.where(drop[:, None], null_ids, ids)
        mask = torch.where(drop[:, None], pos == 0, mask.bool())
        return {"token_ids": ids, "attn_mask": mask}

    def forward(self, context: dict[str, torch.Tensor], drop: torch.Tensor | None = None) -> ContextEmbedderOutput:
        if drop is not None:
            context = self.drop_conditions(context, drop)
        ids = context["token_ids"]
        mask = context.get("attn_mask")
        mask = ids != PAD_ID if mask is None else mask.bool()
        if ids.shape[1] != self.max_len:
            raise ValueError(f"token sequence length {ids.shape[1]} != embedder max_len {self.max_len}")
        x = self.tok_embed(ids.long())
        cos, sin = rope_1d_cos_sin(self.max_len, self._head_dim, device=x.device)
        for block in self.blocks:
            x = block(x, cos, sin, mask)
        x = self.final_norm(x).to(x.dtype)
        out: ContextEmbedderOutput = {"embeddings": x, "attn_mask": mask}
        if self.pooled:
            w = mask.to(x.dtype)[..., None]
            out["pooled_embeddings"] = (x * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
        return out
