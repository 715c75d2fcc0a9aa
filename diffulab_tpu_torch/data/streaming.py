"""Sharded streaming dataset format (port of diffulab_tpu/data/streaming.py).

The reference stores precomputed VAE latents / DINO features in MosaicML MDS
shards (vision_towers/common.py:86-178, repa/common.py:62-139, read back by
datasets/imagenet.py). This format serves the same role with zero deps, and
the port reads and writes the very files the JAX package does:

    dataset_dir/
      index.json            {"shards": [{"file": ..., "n": ...}], "columns": [...]}
      shard_00000.npz       one stacked array per column  [n, ...]

Columns with uniform per-sample shapes (latents, features, labels) are stacked
ndarrays; strings (captions) are object arrays. Shards load lazily with an LRU
cache, so epoch-shuffled random access streams at most a few shards at a time.
``ShardedDatasetWriter`` appends samples and flushes every ``shard_size``.

Not ported yet: reading a MosaicML MDS directory (the reference's
``data/mds.py``, ROADMAP queue 1, item 11) raises.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path
from typing import Any, Iterator

import numpy as np

INDEX_NAME = "index.json"


class ShardedDatasetWriter:
    def __init__(self, out_dir: str | Path, shard_size: int = 1024):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.shard_size = shard_size
        self._buffer: list[dict[str, Any]] = []
        self._shards: list[dict[str, Any]] = []
        self._columns: list[str] | None = None

    def write(self, sample: dict[str, Any]) -> None:
        if self._columns is None:
            self._columns = sorted(sample.keys())
        if sorted(sample.keys()) != self._columns:
            raise ValueError(f"inconsistent columns: {sorted(sample.keys())} vs {self._columns}")
        self._buffer.append(sample)
        if len(self._buffer) >= self.shard_size:
            self._flush()

    def _flush(self) -> None:
        if not self._buffer:
            return
        assert self._columns is not None
        shard_file = f"shard_{len(self._shards):05d}.npz"
        arrays = {}
        for col in self._columns:
            values = [s[col] for s in self._buffer]
            if isinstance(values[0], str):
                arrays[col] = np.array(values, dtype=object)
            else:
                np_values = [np.asarray(v) for v in values]
                if len({v.shape for v in np_values}) == 1:
                    arrays[col] = np.stack(np_values)
                else:
                    # heterogeneous shapes (multi-aspect-ratio latents): object column
                    obj = np.empty(len(np_values), dtype=object)
                    for i, v in enumerate(np_values):
                        obj[i] = v
                    arrays[col] = obj
        np.savez(self.out_dir / shard_file, **arrays)
        self._shards.append({"file": shard_file, "n": len(self._buffer)})
        self._buffer = []

    def close(self) -> None:
        self._flush()
        with open(self.out_dir / INDEX_NAME, "w") as f:
            json.dump({"shards": self._shards, "columns": self._columns or []}, f, indent=2)

    def __enter__(self) -> "ShardedDatasetWriter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _is_mds_index(index: dict) -> bool:
    shards = index.get("shards") or []
    return bool(shards) and isinstance(shards[0], dict) and shards[0].get("format") == "mds"


class ShardedDataset:
    """Random-access reader with an LRU shard cache."""

    def __init__(self, dataset_dir: str | Path, cache_shards: int = 4):
        self.dataset_dir = Path(dataset_dir)
        with open(self.dataset_dir / INDEX_NAME) as f:
            index = json.load(f)
        if _is_mds_index(index):
            raise NotImplementedError(
                f"{self.dataset_dir} is a MosaicML MDS directory; its reader (data/mds.py) is not ported yet "
                "(ROADMAP queue 1, item 11)"
            )
        self.shards: list[dict[str, Any]] = index["shards"]
        self.columns: list[str] = index["columns"]
        self._offsets = np.cumsum([0] + [s["n"] for s in self.shards])
        self._cache: OrderedDict[int, dict[str, np.ndarray]] = OrderedDict()
        self._cache_shards = cache_shards

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _load_shard(self, shard_idx: int) -> dict[str, np.ndarray]:
        if shard_idx in self._cache:
            self._cache.move_to_end(shard_idx)
            return self._cache[shard_idx]
        path = self.dataset_dir / self.shards[shard_idx]["file"]
        with np.load(path, allow_pickle=True) as data:
            shard = {k: data[k] for k in data.files}
        self._cache[shard_idx] = shard
        if len(self._cache) > self._cache_shards:
            self._cache.popitem(last=False)
        return shard

    def __getitem__(self, idx: int) -> dict[str, Any]:
        if idx < 0:
            idx += len(self)
        shard_idx = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        local = idx - int(self._offsets[shard_idx])
        shard = self._load_shard(shard_idx)
        return {k: v[local] for k, v in shard.items()}

    def __iter__(self) -> Iterator[dict[str, Any]]:
        for i in range(len(self)):
            yield self[i]
