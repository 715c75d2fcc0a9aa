"""The port's data side (diffulab_tpu_torch.data) against the JAX package.

- ``render_shape`` and ``SyntheticShapesDataset`` (both tasks, both splits):
  bitwise equal arrays for the same seed (both are the same numpy code);
- ``DataLoader``: bitwise equal batches in the same order over two epochs,
  shuffled or not, with and without the prefetch thread, after
  ``set_epoch`` (a resumed run), and the same length; an error of the
  dataset raised in the consumer;
- the native ``gather_normalize_u8`` against the JAX package's: bitwise
  equal (the same C++ loop built with the same optimisation flags, so the
  same contraction of ``x * scale + bias``); the NumPy
  fallback for a failed build within 2^-23 absolute of the native path (the
  native loop may contract ``x * scale + bias`` into one FMA, NumPy rounds
  ``x * scale``, in [0, 2], first: half an ulp of 2);
- MNIST, CIFAR-10 and image-folder datasets on files the tests write:
  bitwise equal images, labels and batches.
"""

import pickle

import numpy as np
import pytest
import torch
from _torch_port_common import write_mnist
from PIL import Image

from diffulab_tpu.data import native as jnative
from diffulab_tpu.data.cifar10 import CIFAR10Dataset as JaxCIFAR10
from diffulab_tpu.data.folder import ImageFolderDataset as JaxFolder
from diffulab_tpu.data.loader import DataLoader as JaxLoader
from diffulab_tpu.data.mnist import MNISTDataset as JaxMNIST
from diffulab_tpu.data.synthetic import SyntheticShapesDataset as JaxShapes
from diffulab_tpu.data.synthetic import render_shape as jax_render_shape
from diffulab_tpu_torch.data import (
    CIFAR10Dataset,
    DataLoader,
    ImageFolderDataset,
    MNISTDataset,
    SyntheticShapesDataset,
    native,
)
from diffulab_tpu_torch.data.synthetic import render_shape
from diffulab_tpu_torch.ops import _build


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_tree_equal(ours, ref):
    if isinstance(ref, dict):
        assert set(ours) == set(ref)
        for k in ref:
            _assert_tree_equal(ours[k], ref[k])
    else:
        ours, ref = np.asarray(ours), np.asarray(ref)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)


# --- synthetic shapes ----------------------------------------------------------

@pytest.mark.parametrize("label", range(10))
def test_render_shape_is_bitwise_the_jax_one(label):
    ours = render_shape(np.random.default_rng(label), label, 16)
    ref = jax_render_shape(np.random.default_rng(label), label, 16)
    assert ours.dtype == np.uint8 and ours.shape == (16, 16, 3)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("task", ["generate", "colorize"])
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_dataset_is_bitwise_the_jax_one(task, train):
    kw = dict(train=train, n_samples=24, image_size=16, seed=3, task=task)
    ours, ref = SyntheticShapesDataset(**kw), JaxShapes(**kw)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    assert len(ours) == 24 and ours.images.dtype == np.uint8
    _assert_tree_equal(ours[5], ref[5])
    _assert_tree_equal(ours.get_batch([7, 0, 23, 7]), ref.get_batch([7, 0, 23, 7]))
    if task == "colorize":
        assert ours[5]["model_inputs"]["x_context"].shape == (16, 16, 1)


def test_synthetic_splits_differ():
    a = SyntheticShapesDataset(train=True, n_samples=4, image_size=8)
    b = SyntheticShapesDataset(train=False, n_samples=4, image_size=8)
    assert not np.array_equal(a.images, b.images)


# --- loader ------------------------------------------------------------------------

def _shapes(n=40):
    kw = dict(n_samples=n, image_size=8, seed=1)
    return SyntheticShapesDataset(**kw), JaxShapes(**kw)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_batch_order_equals_jax_over_two_epochs(shuffle, prefetch):
    ours_ds, ref_ds = _shapes()
    ours = DataLoader(ours_ds, batch_size=8, shuffle=shuffle, seed=5, prefetch=prefetch)
    ref = JaxLoader(ref_ds, batch_size=8, shuffle=shuffle, seed=5, prefetch=prefetch)
    assert len(ours) == len(ref) == 5
    epochs = []
    for epoch in range(2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)
        epochs.append(np.concatenate([b["model_inputs"]["y"] for b in got]))
    assert shuffle != np.array_equal(epochs[0], epochs[1])


def test_loader_resumed_epoch_replays_the_uninterrupted_order():
    ours_ds, ref_ds = _shapes()
    straight = DataLoader(ours_ds, batch_size=8, seed=2, prefetch=0)
    list(straight)
    second = [b["model_inputs"]["y"] for b in straight]
    resumed = DataLoader(ours_ds, batch_size=8, seed=2, prefetch=0)
    resumed.set_epoch(1)
    ref = JaxLoader(ref_ds, batch_size=8, seed=2, prefetch=0)
    ref.set_epoch(1)
    for a, b, c in zip(second, (b["model_inputs"]["y"] for b in resumed), (b["model_inputs"]["y"] for b in ref)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("n, batch_size", [(37, 8), (40, 8), (8, 8), (7, 8), (37, 1), (37, 5)])
def test_loader_len_equals_jax(n, batch_size):
    ours_ds, ref_ds = _shapes(n)
    ours = DataLoader(ours_ds, batch_size=batch_size, seed=4, prefetch=0)
    ref = JaxLoader(ref_ds, batch_size=batch_size, seed=4, prefetch=0, process_index=0, process_count=1)
    assert len(ours) == len(ref) == n // batch_size
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == len(ours)
    for a, b in zip(got, want):
        _assert_tree_equal(a, b)


class _ItemsOnly:
    """A dataset without ``get_batch``: the loader collates its items."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]


def test_loader_collates_the_items_of_a_dataset_without_get_batch():
    ours_ds, ref_ds = _shapes(16)
    ours = DataLoader(_ItemsOnly(ours_ds), batch_size=4, seed=1, prefetch=2)
    ref = JaxLoader(_ItemsOnly(ref_ds), batch_size=4, seed=1, prefetch=2, process_index=0, process_count=1)
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _assert_tree_equal(a, b)


class _FailsAtThirdBatch(_ItemsOnly):
    def get_batch(self, indices):
        self.calls = getattr(self, "calls", 0) + 1
        if self.calls == 3:
            raise OSError("unreadable sample")
        return self.ds.get_batch(indices)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_raises_an_error_of_the_dataset(prefetch):
    # an error in the prefetch thread must not pass for the end of the epoch
    loader = DataLoader(_FailsAtThirdBatch(_shapes()[0]), batch_size=8, prefetch=prefetch)
    got = []
    with pytest.raises(OSError, match="unreadable sample"):
        for batch in loader:
            got.append(batch)
    assert len(got) == 2


# --- native collate ----------------------------------------------------------------

def test_native_library_builds_and_loads():
    assert native.load() and native.HAS_NATIVE
    assert native._lib_path().parent == _build.BUILD_DIR and native._lib_path().is_file()
    assert native._lib_path().name.startswith("collate-")


@pytest.mark.parametrize("n", [5, 300])  # under and over the threaded path's 2^16 elements
def test_native_gather_normalize_u8_is_bitwise_the_jax_one(n):
    rng = np.random.default_rng(n)
    store = rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)
    idx = rng.integers(0, n, 2 * n)
    ours = native.gather_normalize_u8(store, idx)
    ref = jnative.gather_normalize_u8(store, idx)
    assert jnative.HAS_NATIVE and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_native_fallback_within_half_an_ulp_of_two(monkeypatch):
    rng = np.random.default_rng(0)
    store = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1)
    idx = rng.integers(0, 4, 6)
    fast = native.gather_normalize_u8(store, idx)
    monkeypatch.setattr(native, "_lib", None)
    slow = native.gather_normalize_u8(store, idx)
    np.testing.assert_allclose(fast, slow, rtol=0, atol=2.0**-23)
    # the reference's fallback expression (native.py's NumPy path)
    np.testing.assert_array_equal(slow, store[idx].astype(np.float32) * (1.0 / 127.5) + -1.0)


def test_native_rejects_out_of_range_indices():
    store = np.zeros((4, 2, 2, 1), np.uint8)
    with pytest.raises(IndexError):
        native.gather_normalize_u8(store, np.array([0, 4]))
    with pytest.raises(IndexError):
        native.gather_normalize_u8(store, np.array([-1]))


def test_get_batch_takes_the_native_path_for_uint8(monkeypatch):
    ds, _ = _shapes(8)
    calls = []
    original = native.gather_normalize_u8
    monkeypatch.setattr(native, "gather_normalize_u8", lambda *a, **k: calls.append(1) or original(*a, **k))
    batch = ds.get_batch([1, 2])
    assert calls and batch["model_inputs"]["x"].dtype == np.float32


# --- file datasets --------------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_mnist_equals_jax(tmp_path, train):
    write_mnist(tmp_path)
    ours, ref = MNISTDataset(str(tmp_path), train=train), JaxMNIST(str(tmp_path), train=train)
    assert ours.images.shape == ((12 if train else 5), 32, 32, 1)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    _assert_tree_equal(ours[3], ref[3])
    _assert_tree_equal(ours.get_batch([4, 0, 1]), ref.get_batch([4, 0, 1]))


def test_cifar10_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    for name in ("data_batch_1", "data_batch_2"):
        with open(tmp_path / name, "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (6, 3072), dtype=np.uint8),
                         "labels": rng.integers(0, 10, 6).tolist()}, f)
    kw = dict(batches_to_load=["data_batch_1", "data_batch_2"])
    ours, ref = CIFAR10Dataset(str(tmp_path), **kw), JaxCIFAR10(str(tmp_path), **kw)
    assert ours.images.shape == (12, 32, 32, 3)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    _assert_tree_equal(ours[7], ref[7])
    _assert_tree_equal(ours.get_batch([11, 2]), ref.get_batch([11, 2]))


@pytest.mark.parametrize("split", ["train", "val", "all"])
@pytest.mark.parametrize("grayscale", [False, True])
def test_image_folder_equals_jax(tmp_path, split, grayscale):
    rng = np.random.default_rng(2)
    for cls in ("cats", "dogs"):
        (tmp_path / cls).mkdir()
        for i in range(12):  # img8 and img9 fall in the 0.3 validation split
            size = (20 + i, 16)
            Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(tmp_path / cls / f"img{i}.png")
    kw = dict(image_size=8, split=split, val_fraction=0.3, grayscale=grayscale)
    ours, ref = ImageFolderDataset(str(tmp_path), **kw), JaxFolder(str(tmp_path), **kw)
    assert ours.n_classes == ref.n_classes == 2 and ours.class_names == ["cats", "dogs"]
    assert ours.images.shape[1:] == (8, 8, 1 if grayscale else 3) and len(ours) == len(ref) > 0
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    _assert_tree_equal(ours.get_batch([0, len(ours) - 1]), ref.get_batch([0, len(ref) - 1]))


def test_image_folder_flat_and_missing(tmp_path):
    Image.fromarray(np.zeros((10, 10, 3), np.uint8)).save(tmp_path / "a.png")
    ds = ImageFolderDataset(str(tmp_path), image_size=4, split="all")
    assert ds.n_classes == 1 and len(ds) == 1
    with pytest.raises(FileNotFoundError):
        ImageFolderDataset(str(tmp_path / "missing"))
    with pytest.raises(ValueError):
        ImageFolderDataset(str(tmp_path), split="test")
