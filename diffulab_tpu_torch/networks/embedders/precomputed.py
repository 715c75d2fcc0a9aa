"""Precomputed-embedding passthrough embedder (port of
diffulab_tpu/networks/embedders/precomputed.py).

Token embeddings are computed offline by a frozen language model and stored
with the dataset; this embedder only swaps in a stored null embedding (and
its mask) for the samples whose condition is dropped. The null embedding is
a buffer, not a parameter (an ``nnx.Variable`` in the JAX package), and is
not part of the ``state_dict``: it comes from the constructor, as an array
or a ``.npy`` file, so a bridged JAX parameter state loads strictly.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from diffulab_tpu_torch.networks.embedders.common import ContextEmbedder, ContextEmbedderOutput
from diffulab_tpu_torch.utils import resolve_device


def _load_null_embedding(path: str | Path) -> np.ndarray:
    """A stored null embedding: ``.npy``, or a torch ``.pt``."""
    path = Path(path)
    if path.suffix == ".npy":
        return np.load(path)
    return torch.load(path, map_location="cpu", weights_only=True).float().numpy()


class PrecomputedEmbedder(ContextEmbedder):
    def __init__(
        self,
        path_null_embedding: str | Path | None = None,
        null_embedding_seq_len: int = 0,
        null_embedding: np.ndarray | None = None,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__()
        if null_embedding is None:
            if path_null_embedding is None:
                raise ValueError("give null_embedding or path_null_embedding")
            null_embedding = _load_null_embedding(path_null_embedding)
        null_embedding = np.squeeze(np.asarray(null_embedding))
        if null_embedding.ndim != 2:
            raise ValueError(f"null embedding must be [L, D], got shape {null_embedding.shape}")
        device = resolve_device(device)
        self.register_buffer("null_embedding",
                             torch.as_tensor(null_embedding, dtype=torch.float32, device=device).clone(),
                             persistent=False)
        mask = torch.zeros((null_embedding.shape[0],), dtype=torch.bool, device=device)
        mask[:null_embedding_seq_len] = True
        self.register_buffer("null_embedding_mask", mask, persistent=False)
        self._output_size = (null_embedding.shape[-1],)
        self._n_output = 1

    def drop_conditions(self, context: ContextEmbedderOutput, drop: torch.Tensor) -> ContextEmbedderOutput:
        emb = context["embeddings"]
        null_emb = self.null_embedding.to(emb.dtype)
        embeddings = torch.where(drop[:, None, None], null_emb[None].expand(emb.shape), emb)
        attn_mask = context.get("attn_mask")
        if attn_mask is None:
            attn_mask = torch.ones(emb.shape[:2], dtype=torch.bool, device=emb.device)
        attn_mask = torch.where(drop[:, None], self.null_embedding_mask[None].expand(attn_mask.shape), attn_mask)
        return {"embeddings": embeddings, "attn_mask": attn_mask}

    def forward(self, context: ContextEmbedderOutput, drop: torch.Tensor | None = None) -> ContextEmbedderOutput:
        if drop is None:
            drop = torch.zeros((context["embeddings"].shape[0],), dtype=torch.bool,
                               device=context["embeddings"].device)
        return self.drop_conditions(context, drop)
