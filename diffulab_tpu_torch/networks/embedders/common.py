"""Context embedder interface (port of diffulab_tpu/networks/embedders/common.py).

An embedder maps raw conditioning (precomputed embedding dicts, tokenized
text, ...) to a :data:`ContextEmbedderOutput`. The drop decision is an
explicit per-sample boolean mask, so the fused CFG batch passes a constant
``[zeros; ones]`` mask.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

# keys: "embeddings" (required, [B, L, D]), "pooled_embeddings" ([B, Dp]),
# "attn_mask" ([B, L] bool)
ContextEmbedderOutput = Dict[str, torch.Tensor]


class ContextEmbedder(nn.Module):
    """Abstract context embedder.

    Attributes:
        n_output: number of output embeddings (2 when a pooled embedding is
            returned alongside token embeddings, e.g. SD3's CLIP pooled).
        output_size: per-output embedding dims; ``(pooled_dim, token_dim)``
            when ``n_output == 2`` else ``(token_dim,)``.
    """

    _n_output: int
    _output_size: tuple[int, ...]

    @property
    def n_output(self) -> int:
        return self._n_output

    @property
    def output_size(self) -> tuple[int, ...]:
        return self._output_size

    def drop_conditions(self, context: Any, drop: torch.Tensor) -> Any:
        """Replace context by the null condition where ``drop`` is True."""
        raise NotImplementedError

    def forward(self, context: Any, drop: torch.Tensor | None = None) -> ContextEmbedderOutput:
        raise NotImplementedError
