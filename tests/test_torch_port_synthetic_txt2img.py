"""The port's hard synthetic dataset (``diffulab_tpu_torch.data.synthetic_txt2img``)
against the JAX package's, on the CPU: the train and validation splits at a
small ``n_samples`` bitwise equal (images, labels, specs, captions), the
caption embedding table and ``embed_captions`` equal, and the judge
(``judge_image``, ``caption_consistency``) equal on rendered images and on
noised ones; then the dataset through the port's loader and config layer.
"""

import numpy as np
import pytest

import diffulab_tpu.data.synthetic_txt2img as jax_ds
import diffulab_tpu_torch.data.synthetic_txt2img as ds
from diffulab_tpu_torch.config import compose_config, instantiate
from diffulab_tpu_torch.data.loader import DataLoader
from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR


@pytest.fixture(scope="module", params=[True, False], ids=["train", "val"])
def pair(request):
    kw = dict(train=request.param, n_samples=24, image_size=64, seed=3)
    return jax_ds.SyntheticCompositionalDataset(**kw), ds.SyntheticCompositionalDataset(**kw)


def test_dataset_is_bitwise_the_jax_dataset(pair):
    ref, ours = pair
    assert ours.images.dtype == np.uint8 and ours.images.shape == (24, 64, 64, 3)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    assert ours.specs == ref.specs and ours.captions == ref.captions
    assert ours.n_classes == ref.n_classes == 5
    for got, want in zip(ours.get_batch([3, 0, 7])["model_inputs"].values(),
                         ref.get_batch([3, 0, 7])["model_inputs"].values()):
        np.testing.assert_array_equal(got, want)


def test_caption_embeddings_and_parsing_match():
    np.testing.assert_array_equal(ds.caption_embedding_table(), jax_ds.caption_embedding_table())
    assert ds.VOCAB == jax_ds.VOCAB
    table = ds.caption_embedding_table(dim=16, seed=5)
    captions = ["two large cyan rings on a light background", "one small red disk on a dark background"]
    for got, want in zip(ds.embed_captions(captions, table), jax_ds.embed_captions(captions, table)):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(0)
    for _ in range(20):
        spec = ds.draw_spec(rng)
        assert ds.parse_caption(ds.caption_of(spec)) == jax_ds.parse_caption(jax_ds.caption_of(spec)) == spec


def test_judge_matches_on_rendered_and_noised_images(pair):
    ref, ours = pair
    clean = ours.images.astype(np.float32) / 127.5 - 1.0
    noisy = np.clip(clean + 0.3 * np.random.default_rng(1).standard_normal(clean.shape).astype(np.float32), -1, 1)
    for images in (clean, noisy):
        for img in images[:8]:
            assert ds.judge_image(img) == jax_ds.judge_image(img)
        got = ds.caption_consistency(images, ours.captions)
        assert got == jax_ds.caption_consistency(images, ref.captions)
    # clean renders judge well (the reference's stated ceilings: color, count and background ~1.0)
    clean_scores = ds.caption_consistency(clean, ours.captions)
    assert clean_scores["background"] == 1.0 and clean_scores["count"] >= 0.9


def test_the_hard_configs_build_the_port_dataset_and_load_it():
    cfg = compose_config(CONFIG_DIR, "train_synthetic_hard_flow", ["dataset.train.n_samples=16"])
    train = instantiate(cfg["dataset"]["train"])
    assert isinstance(train, ds.SyntheticCompositionalDataset) and train.images.shape == (16, 64, 64, 3)
    batch = next(iter(DataLoader(train, batch_size=8, shuffle=False, prefetch=0)))
    x = batch["model_inputs"]["x"]
    assert x.shape == (8, 64, 64, 3) and x.dtype == np.float32
    np.testing.assert_allclose(x, train.images[:8] / 127.5 - 1.0, atol=1e-6, rtol=0)  # the native gather's rounding
    np.testing.assert_array_equal(batch["model_inputs"]["y"], train.labels[:8])
