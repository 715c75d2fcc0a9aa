"""Datasets and the loader of the port (numpy only; port of diffulab_tpu/data/)."""

from diffulab_tpu_torch.data.base import BaseDataset, BatchData
from diffulab_tpu_torch.data.cifar10 import CIFAR10Dataset
from diffulab_tpu_torch.data.folder import ImageFolderDataset
from diffulab_tpu_torch.data.loader import DataLoader
from diffulab_tpu_torch.data.mnist import MNISTDataset
from diffulab_tpu_torch.data.synthetic import SyntheticShapesDataset

__all__ = ["BaseDataset", "BatchData", "CIFAR10Dataset", "DataLoader", "ImageFolderDataset", "MNISTDataset",
           "SyntheticShapesDataset"]
