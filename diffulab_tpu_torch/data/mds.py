"""Reader and writer of MosaicML ``streaming`` MDS shard directories (port of
diffulab_tpu/data/mds.py; NumPy and JSON only).

The reference's production datasets are MDS shards written by
``streaming.base.MDSWriter`` (reference vision_towers/common.py:86-178,
repa/common.py:62-139) and read back by ``StreamingDataset``
(reference datasets/imagenet.py:18-86). This module reads and writes the
on-disk format directly, so reference-produced latent and caption datasets
load into the port (:class:`~diffulab_tpu_torch.data.streaming.ShardedDataset`
detects the format), and the port writes the bytes the JAX package writes.

On-disk layout (streaming/base/format/mds):

    index.json: {"version": 2, "shards": [{"format": "mds", "column_names":
        [...], "column_encodings": [...], "column_sizes": [...],
        "raw_data": {"basename": ...}, "samples": n, ...}, ...]}
    shard file: [uint32 n][uint32 offsets[n+1] (absolute)][shard-config blob]
        [sample bytes ...]
    sample: uint32 size prefixes for each variable-size column (in column
        order), then the encoded column payloads (in column order).

Encodings: str, bytes, json, pkl, int (int64), float (float64), the numpy
scalar encodings (uint8..float64), and ndarray[:dtype[:shape]], whose header
holds what the encoding string leaves dynamic: [uint8 dtype_id] when the
dtype is, [uint8 ndim][uint32*ndim shape] when the shape is. jpeg, png and
pil decode through PIL.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterator

import numpy as np

# streaming/base/format/mds/encodings.py dtype ids (log2-size + class offset)
_MDS_ID2DTYPE = {
    8: "uint8", 9: "uint16", 10: "uint32", 11: "uint64",
    16: "int8", 17: "int16", 18: "int32", 19: "int64",
    24: "float16", 25: "float32", 26: "float64",
}
_MDS_DTYPE2ID = {v: k for k, v in _MDS_ID2DTYPE.items()}

_SCALAR_ENCODINGS = frozenset(_MDS_DTYPE2ID)


def _parse_ndarray_encoding(encoding: str) -> tuple[str | None, tuple[int, ...] | None]:
    parts = encoding.split(":")
    dtype = parts[1] if len(parts) > 1 and parts[1] else None
    shape = tuple(int(s) for s in parts[2].split(",")) if len(parts) > 2 and parts[2] else None
    return dtype, shape


def mds_decode(encoding: str, data: bytes) -> Any:
    """Decode one column payload by its MDS encoding string (mds.py:58)."""
    if encoding == "bytes":
        return data
    if encoding == "str":
        return data.decode("utf-8")
    if encoding == "int":
        return int(np.frombuffer(data, np.int64)[0])
    if encoding == "float":
        return float(np.frombuffer(data, np.float64)[0])
    if encoding in _SCALAR_ENCODINGS:
        return np.frombuffer(data, np.dtype(encoding))[0]
    if encoding == "json":
        return json.loads(data.decode("utf-8"))
    if encoding == "pkl":
        import pickle

        return pickle.loads(data)
    if encoding in ("jpeg", "png", "pil"):
        import io

        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)))
    if encoding.startswith("ndarray"):
        dtype, shape = _parse_ndarray_encoding(encoding)
        idx = 0
        if dtype is None:
            dtype = _MDS_ID2DTYPE[int(np.frombuffer(data[:1], np.uint8)[0])]
            idx = 1
        if shape is None:
            ndim = int(np.frombuffer(data[idx:idx + 1], np.uint8)[0])
            idx += 1
            shape = tuple(np.frombuffer(data[idx:idx + 4 * ndim], np.uint32).tolist())
            idx += 4 * ndim
        return np.frombuffer(data[idx:], np.dtype(dtype)).reshape(shape)
    raise ValueError(f"unsupported MDS encoding: {encoding!r}")


def mds_encode(encoding: str, value: Any) -> bytes:
    """Encode one column value by its MDS encoding string (mds.py:95)."""
    if encoding == "bytes":
        return bytes(value)
    if encoding == "str":
        return str(value).encode("utf-8")
    if encoding == "int":
        return np.int64(value).tobytes()
    if encoding == "float":
        return np.float64(value).tobytes()
    if encoding in _SCALAR_ENCODINGS:
        return np.dtype(encoding).type(value).tobytes()
    if encoding == "json":
        return json.dumps(value).encode("utf-8")
    if encoding == "pkl":
        import pickle

        return pickle.dumps(value)
    if encoding.startswith("ndarray"):
        dtype, shape = _parse_ndarray_encoding(encoding)
        arr = np.asarray(value)
        parts = []
        if dtype is None:
            parts.append(np.uint8(_MDS_DTYPE2ID[arr.dtype.name]).tobytes())
        else:
            arr = arr.astype(np.dtype(dtype), copy=False)
        if shape is None:
            parts.append(np.uint8(arr.ndim).tobytes())
            parts.append(np.asarray(arr.shape, np.uint32).tobytes())
        elif tuple(arr.shape) != shape:
            raise ValueError(f"{arr.shape} != fixed {shape}")
        parts.append(arr.tobytes())
        return b"".join(parts)
    raise ValueError(f"unsupported MDS encoding: {encoding!r}")


def mds_encoding_size(encoding: str) -> int | None:
    """Fixed byte size of an encoding, or None when variable (``column_sizes``)."""
    if encoding in ("int", "float"):
        return 8
    if encoding in _SCALAR_ENCODINGS:
        return np.dtype(encoding).itemsize
    if encoding.startswith("ndarray"):
        dtype, shape = _parse_ndarray_encoding(encoding)
        if dtype is not None and shape is not None:
            return int(np.dtype(dtype).itemsize * np.prod(shape))
    return None


def is_mds_index(index: dict) -> bool:
    shards = index.get("shards") or []
    return bool(shards) and isinstance(shards[0], dict) and shards[0].get("format") == "mds"


class _MDSShard:
    """One .mds file: absolute sample offsets and per-sample column decode."""

    def __init__(self, path: Path, info: dict):
        if info.get("compression"):
            raise NotImplementedError(f"compressed MDS shards ({info['compression']}) are not supported; "
                                      "re-materialize the dataset uncompressed")
        self.path = path
        self.n = int(info["samples"])
        self.column_names: list[str] = info["column_names"]
        self.column_encodings: list[str] = info["column_encodings"]
        self.column_sizes: list[int | None] = info["column_sizes"]
        self._offsets: np.ndarray | None = None

    def _load_offsets(self) -> np.ndarray:
        if self._offsets is None:
            with open(self.path, "rb") as f:
                header = f.read(4 + 4 * (self.n + 1))
            n = int(np.frombuffer(header[:4], np.uint32)[0])
            if n != self.n:
                raise ValueError(f"{self.path}: shard header {n} != index {self.n} samples")
            self._offsets = np.frombuffer(header[4:], np.uint32)
        return self._offsets

    def get_sample(self, idx: int) -> dict[str, Any]:
        offsets = self._load_offsets()
        begin, end = int(offsets[idx]), int(offsets[idx + 1])
        with open(self.path, "rb") as f:
            f.seek(begin)
            data = f.read(end - begin)
        sizes: list[int] = []
        pos = 0
        for size in self.column_sizes:
            if size is not None:
                sizes.append(int(size))
            else:
                sizes.append(int(np.frombuffer(data[pos:pos + 4], np.uint32)[0]))
                pos += 4
        out: dict[str, Any] = {}
        for name, encoding, size in zip(self.column_names, self.column_encodings, sizes):
            out[name] = mds_decode(encoding, data[pos:pos + size])
            pos += size
        return out


class MDSShardedDataset:
    """Random-access reader over an MDS directory (index.json + .mds files),
    with :class:`~diffulab_tpu_torch.data.streaming.ShardedDataset`'s interface."""

    def __init__(self, dataset_dir: str | Path, index: dict | None = None):
        self.dataset_dir = Path(dataset_dir)
        if index is None:
            with open(self.dataset_dir / "index.json") as f:
                index = json.load(f)
        self.shards = [_MDSShard(self.dataset_dir / s["raw_data"]["basename"], s) for s in index["shards"]]
        self.columns: list[str] = list(self.shards[0].column_names) if self.shards else []
        self._offsets = np.cumsum([0] + [s.n for s in self.shards])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int) -> dict[str, Any]:
        if idx < 0:
            idx += len(self)
        shard_idx = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.shards[shard_idx].get_sample(idx - int(self._offsets[shard_idx]))

    def __iter__(self) -> Iterator[dict[str, Any]]:
        for i in range(len(self)):
            yield self[i]


class MDSDatasetWriter:
    """Write an MDS directory (index.json + .mds shards), readable by
    :class:`MDSShardedDataset`, by the JAX package's and by the reference's
    mosaicml-streaming reader. ``columns`` maps name -> MDS encoding string,
    as ``MDSWriter(columns=...)`` (e.g. ``{"vision_latents": "ndarray:float32",
    "label": "int"}``)."""

    def __init__(self, out_dir: str | Path, columns: dict[str, str], shard_size: int = 1024):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.columns = dict(columns)
        self.shard_size = shard_size
        self._samples: list[bytes] = []
        self._shards: list[dict[str, Any]] = []

    def _encode_sample(self, sample: dict[str, Any]) -> bytes:
        if set(sample) != set(self.columns):
            raise ValueError(f"sample columns {sorted(sample)} != writer columns {sorted(self.columns)}")
        size_prefixes: list[bytes] = []
        payloads: list[bytes] = []
        for name, encoding in self.columns.items():
            data = mds_encode(encoding, sample[name])
            if mds_encoding_size(encoding) is None:
                size_prefixes.append(np.uint32(len(data)).tobytes())
            payloads.append(data)
        return b"".join(size_prefixes + payloads)

    def write(self, sample: dict[str, Any]) -> None:
        self._samples.append(self._encode_sample(sample))
        if len(self._samples) >= self.shard_size:
            self._flush()

    def _shard_info(self, basename: str, n: int, nbytes: int) -> dict[str, Any]:
        return {
            "column_encodings": list(self.columns.values()),
            "column_names": list(self.columns.keys()),
            "column_sizes": [mds_encoding_size(e) for e in self.columns.values()],
            "compression": None,
            "format": "mds",
            "hashes": [],
            "raw_data": {"basename": basename, "bytes": nbytes, "hashes": {}},
            "samples": n,
            "size_limit": None,
            "version": 2,
            "zip_data": None,
        }

    def _flush(self) -> None:
        if not self._samples:
            return
        basename = f"shard.{len(self._shards):05d}.mds"
        n = len(self._samples)
        # the shard's own config blob sits between the offsets and the data
        # (readers address samples through the absolute offsets alone)
        config = json.dumps(self._shard_info(basename, n, 0)).encode("utf-8")
        header_len = 4 + 4 * (n + 1) + len(config)
        sizes = np.array([len(s) for s in self._samples], np.uint64)
        offsets = (header_len + np.concatenate([[0], np.cumsum(sizes)])).astype(np.uint32)
        blob = b"".join([np.uint32(n).tobytes(), offsets.tobytes(), config] + self._samples)
        (self.out_dir / basename).write_bytes(blob)
        self._shards.append(self._shard_info(basename, n, len(blob)))
        self._samples = []

    def close(self) -> None:
        self._flush()
        with open(self.out_dir / "index.json", "w") as f:
            json.dump({"version": 2, "shards": self._shards}, f, indent=2)

    def __enter__(self) -> "MDSDatasetWriter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
