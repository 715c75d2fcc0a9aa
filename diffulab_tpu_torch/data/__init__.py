"""Datasets of the port (numpy only; port of diffulab_tpu/data/)."""

from diffulab_tpu_torch.data.base import BaseDataset, BatchData

__all__ = ["BaseDataset", "BatchData"]
