"""Slice G1's data in the port against the JAX package, on the CPU
(``data/{mds,streaming,imagenet}.py``):

- every MDS encoding the JAX file lists (str, bytes, int, float, json, pkl,
  the numpy scalars, ndarray with a dynamic or fixed dtype and shape, png):
  the port's bytes equal the JAX package's, and decode back to the value;
  the fixed sizes agree; an unknown encoding and a fixed shape that does
  not fit raise;
- a directory that the JAX ``MDSDatasetWriter`` writes is read by the
  port's ``ShardedDataset`` and ``MDSShardedDataset``, and the reverse; the
  two writers' files are byte for byte the same;
- ``ImageNetLatentREPA``'s items against the JAX dataset's, with
  ``dst_features`` and with an ``image`` instead, from npz and from MDS
  shards, through the port's loader in batches.
"""

import io
import json

import numpy as np
import pytest
from PIL import Image

from diffulab_tpu.data import imagenet as jimagenet
from diffulab_tpu.data import mds as jmds
from diffulab_tpu.data.streaming import ShardedDataset as JaxShardedDataset
from diffulab_tpu_torch.data import mds
from diffulab_tpu_torch.data.imagenet import ImageNetLatentREPA
from diffulab_tpu_torch.data.loader import DataLoader
from diffulab_tpu_torch.data.streaming import ShardedDataset, ShardedDatasetWriter

_RNG = np.random.default_rng(0)
_ARR = _RNG.standard_normal((3, 4)).astype(np.float32)
_PNG = io.BytesIO()
Image.fromarray(_RNG.integers(0, 256, (4, 5, 3), dtype=np.uint8)).save(_PNG, format="png")

ENCODINGS = [
    ("str", "a red circle"), ("bytes", b"\x00\x01\x02"), ("int", 42), ("int", -7), ("float", 0.1),
    ("json", {"a": [1, 2], "b": None}), ("pkl", {"x": (1, 2.5)}),
    *((name, np.dtype(name).type(3)) for name in ("uint8", "uint16", "uint32", "uint64", "int8", "int16",
                                                  "int32", "int64", "float16", "float32", "float64")),
    ("ndarray", _ARR), ("ndarray", np.arange(5, dtype=np.int64)), ("ndarray:float32", _ARR),
    ("ndarray:float32:3,4", _ARR), ("ndarray:float16:12", _ARR.reshape(12)), ("ndarray::3,4", _ARR.astype(np.int16)),
]


@pytest.mark.parametrize("encoding,value", ENCODINGS, ids=[f"{e}-{i}" for i, (e, _) in enumerate(ENCODINGS)])
def test_mds_encoding_is_bitwise_jax(encoding, value):
    data = mds.mds_encode(encoding, value)
    assert data == jmds.mds_encode(encoding, value)
    assert mds.mds_encoding_size(encoding) == jmds.mds_encoding_size(encoding)
    out, ref = mds.mds_decode(encoding, data), jmds.mds_decode(encoding, data)
    if isinstance(ref, np.ndarray):
        assert out.dtype == ref.dtype and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, np.asarray(value).astype(out.dtype))
    else:
        assert type(out) is type(ref) and out == ref == value


def test_mds_png_and_refusals():
    np.testing.assert_array_equal(mds.mds_decode("png", _PNG.getvalue()), jmds.mds_decode("png", _PNG.getvalue()))
    assert mds.mds_encoding_size("str") is None and mds.mds_encoding_size("ndarray:float32:3,4") == 48
    with pytest.raises(ValueError, match="unsupported MDS encoding"):
        mds.mds_decode("zstd", b"")
    with pytest.raises(ValueError, match="unsupported MDS encoding"):
        mds.mds_encode("zstd", b"")
    with pytest.raises(ValueError, match="fixed"):
        mds.mds_encode("ndarray:float32:2,2", _ARR)


COLUMNS = {"vision_latents": "ndarray:float32", "label": "int", "caption": "str", "dst_features": "ndarray:float16:4,8"}


def _samples(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return [{"vision_latents": rng.standard_normal((2, 2, 4)).astype(np.float32), "label": int(rng.integers(0, 10)),
             "caption": f"sample {i}", "dst_features": rng.standard_normal((4, 8)).astype(np.float16)}
            for i in range(n)]


def _same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for key in a:
        if isinstance(b[key], np.ndarray):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
        else:
            assert a[key] == b[key]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mds_directory_both_directions(writer, tmp_path):
    """7 samples in shards of 3 written by one package, read by the other's
    readers and by its own; the two writers' files are the same bytes."""
    samples = _samples(7)
    for name, module in (("jax", jmds), ("port", mds)):
        with module.MDSDatasetWriter(tmp_path / name, COLUMNS, shard_size=3) as w:
            for s in samples:
                w.write(s)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "index.json", "shard.00000.mds", "shard.00001.mds", "shard.00002.mds"]
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
    root = tmp_path / writer
    assert mds.is_mds_index(json.loads((root / "index.json").read_text()))
    readers = [ShardedDataset(root), mds.MDSShardedDataset(root), JaxShardedDataset(root), jmds.MDSShardedDataset(root)]
    for reader in readers:
        assert len(reader) == 7 and list(reader.columns) == list(COLUMNS)
        for i, s in enumerate(samples):
            _same(reader[i], s)
        _same(reader[-1], samples[-1])
    assert [r["caption"] for r in readers[0]] == [s["caption"] for s in samples]
    with pytest.raises(ValueError, match="writer columns"):
        mds.MDSDatasetWriter(tmp_path / "bad", COLUMNS).write({"label": 1})


def _repa_shards(root, fmt: str, with_features: bool, n: int = 6) -> None:
    rng = np.random.default_rng(2)
    rows = []
    for i in range(n):
        row = {"vision_latents": rng.standard_normal((2, 2, 4)).astype(np.float32), "label": int(i % 4)}
        if with_features:
            row["dst_features"] = rng.standard_normal((3, 8)).astype(np.float32)
        else:
            row["image"] = rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)
        rows.append(row)
    if fmt == "npz":
        with ShardedDatasetWriter(root, shard_size=4) as w:
            for row in rows:
                w.write(row)
    else:
        columns = {"vision_latents": "ndarray:float32", "label": "int",
                   **({"dst_features": "ndarray:float32"} if with_features else {"image": "ndarray:uint8:4,4,3"})}
        with mds.MDSDatasetWriter(root, columns, shard_size=4) as w:
            for row in rows:
                w.write(row)


@pytest.mark.parametrize("fmt", ["npz", "mds"])
@pytest.mark.parametrize("with_features", [True, False], ids=["dst_features", "image"])
def test_imagenet_latent_repa_matches_jax(fmt, with_features, tmp_path):
    _repa_shards(tmp_path / "train", fmt, with_features)
    scale = np.linspace(0.5, 2.0, 4, dtype=np.float32).reshape(1, 1, 1, 4)  # a per-channel scale, batch layout
    ours = ImageNetLatentREPA(str(tmp_path), split="train")
    ref = jimagenet.ImageNetLatentREPA(str(tmp_path), split="train")
    with pytest.raises(ValueError, match="Latent scale"):
        ours[0]
    ours.set_latent_scale(scale)
    ref.set_latent_scale(scale)
    assert len(ours) == len(ref) == 6
    for i in range(6):
        a, b = ours[i], ref[i]
        assert set(a["model_inputs"]) == set(b["model_inputs"]) == {"x", "y"}
        assert set(a["extra"]) == set(b["extra"]) == ({"dst_features"} if with_features else {"x0"})
        for part in ("model_inputs", "extra"):
            for key, value in b[part].items():
                assert a[part][key].dtype == np.asarray(value).dtype, key
                np.testing.assert_array_equal(a[part][key], value)
    batch = next(iter(DataLoader(ours, batch_size=4, shuffle=False)))
    assert batch["model_inputs"]["x"].shape == (4, 2, 2, 4) and batch["model_inputs"]["y"].dtype == np.int64
    assert batch["extra"][("dst_features" if with_features else "x0")].shape == ((4, 3, 8) if with_features
                                                                                 else (4, 4, 4, 3))
