"""Slice H1's data path in the port against the JAX package, on the CPU:
the hard text-to-image benchmark's builder, its tower directory, the
orbax importer, the loader's sampler and collate options and the
benchmark's null embedding.

- ``DataLoader(sampler=MultiARBatchSampler, collate_fn=collate_fn)`` gives
  the JAX loader's batches over two epochs (the sampler's order, the
  captions a list), and ``drop_last=False`` its trailing partial batch.
- ``configs/embedder/precomputed_hard.yaml`` on the builder's
  ``[EMB_LEN, 512]`` zero null embedding with ``null_embedding_seq_len: 1``:
  a dropped sample gets zero embeddings and a mask with only its first
  token on, as the JAX ``PrecomputedEmbedder`` gives.
- One tower step of the builder (recon MSE + kl_weight x KL with the
  noise injected, ``logvar`` clipped): loss, MSE, KL within rel 1e-5, the
  gradients within rel 1e-4 of ``jax.grad`` (each against its largest
  entry, at least 1e-3 of the largest of all: the biases before a
  GroupNorm have zero gradients up to rounding), and the builder's AdamW
  on the JAX gradients within atol 1e-6 of ``optax.adamw``'s update
  (weight decay 1e-4, trap T7).
- From the same bridged tower, the port's ``write_shards`` and the JAX
  builder's write the same columns (latents within rel 1e-4: the fp32
  convolutions of the two frameworks sum in different orders; captions,
  caption embeddings, masks and labels equal) and the same null
  embedding; the latent statistics agree within rel 1e-4.
- ``Flux2VAE(flax_ckpt=...)`` restores the port builder's tower (its
  weights and ``latent_scale = 1 / max(std, 1e-4)``, ``latent_bias =
  mean``), and the importer's copy of a JAX-saved orbax tower, whose
  encode and decode then match the JAX tower within rel 1e-4; the orbax
  directory itself is refused, naming the importer.
- The importer on a JAX run's ``denoiser`` and ``ema`` entries (the
  multimodal MMDiT with a ``PrecomputedEmbedder``, whose null embedding
  and mask are dropped by name): ``restore_train_modules`` loads them
  strictly into the port's model, every parameter equal to the bridged
  JAX one.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_port_common import TINY_TOWER, _randomize, port_mmdit, randomized_jax_mmdit, rel_err
from flax import nnx

from diffulab_tpu.data import imagenet as jimagenet
from diffulab_tpu.data.loader import DataLoader as JaxDataLoader
from diffulab_tpu.data.streaming import ShardedDataset as JaxShardedDataset
from diffulab_tpu.networks.embedders.precomputed import PrecomputedEmbedder as JaxPrecomputedEmbedder
from diffulab_tpu.networks.vision_towers.flux2 import Flux2VAE as JaxFlux2VAE
from diffulab_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from diffulab_tpu.training.checkpoint import trainable_filter as jax_trainable_filter
from diffulab_tpu.training.trainer import _TrainModules
from diffulab_tpu_torch.config import compose_config
from diffulab_tpu_torch.config.instantiate import instantiate
from diffulab_tpu_torch.data.imagenet import MultiARBatchSampler, collate_fn
from diffulab_tpu_torch.data.loader import DataLoader
from diffulab_tpu_torch.data.streaming import ShardedDataset
from diffulab_tpu_torch.data.synthetic_txt2img import EMB_LEN, caption_embedding_table
from diffulab_tpu_torch.networks.vision_towers.flux2 import Flux2VAE
from diffulab_tpu_torch.scripts import build_hard_txt2img as builder
from diffulab_tpu_torch.training.checkpoint import restore_train_modules
from diffulab_tpu_torch.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
KL_WEIGHT = 1e-2  # the builder's 1e-5 would hide the KL term's gradients in the comparison


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def towers():
    """(JAX Flux2VAE built from shapes, its port twin) of TINY_TOWER with the same seeded noise weights."""
    jax_tower = nnx.eval_shape(lambda: JaxFlux2VAE(**TINY_TOWER, rngs=nnx.Rngs(0)))
    params = _randomize(jax_tower, seed=21)
    tower = Flux2VAE(**TINY_TOWER, device="cpu")
    tower.load_state_dict(state_dict_from_jax(params, tower), strict=True)
    return jax_tower, tower


def _flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(str(p) for p in path): np.asarray(v.get_value(), np.float32) for path, v in tree.flat_state()}


# --- the loader's sampler, collate_fn and drop_last ----------------------------------


class _Buckets:
    """Caption-conditional items in two latent buckets, as ImageNetmultiAR gives them."""

    def __init__(self):
        rng = np.random.default_rng(3)
        self.buckets = {(4, 4): list(range(0, 11)), (4, 8): list(range(11, 18))}
        self.items = [{"model_inputs": {"x": rng.standard_normal((4, 4 if i < 11 else 8, 2)).astype(np.float32),
                                        "initial_context": f"caption {i}"}, "extra": {}} for i in range(18)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)], ids=["train", "val"])
def test_loader_with_the_bucket_sampler_equals_jax(shuffle, drop_last):
    ds = _Buckets()
    ours = DataLoader(ds, batch_size=4, collate_fn=collate_fn, prefetch=2,
                      sampler=MultiARBatchSampler(ds, 4, shuffle=shuffle, drop_last=drop_last, seed=5))
    ref = JaxDataLoader(ds, batch_size=4, collate_fn=jimagenet.collate_fn, prefetch=0, process_index=0,
                        process_count=1,
                        sampler=jimagenet.MultiARBatchSampler(ds, 4, shuffle=shuffle, drop_last=drop_last, seed=5))
    assert len(ours) == len(ref)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            assert a["model_inputs"]["initial_context"] == b["model_inputs"]["initial_context"]
            np.testing.assert_array_equal(a["model_inputs"]["x"], b["model_inputs"]["x"])


def test_loader_keeps_the_partial_batch_without_drop_last():
    ds = [{"model_inputs": {"x": np.full((2,), i, np.float32), "initial_context": f"caption {i}"}} for i in range(18)]
    ours = DataLoader(ds, batch_size=5, shuffle=True, seed=2, drop_last=False, prefetch=0)
    ref = JaxDataLoader(ds, batch_size=5, shuffle=True, seed=2, drop_last=False, prefetch=0, process_index=0,
                        process_count=1)
    got, want = list(ours), list(ref)
    assert len(ours) == len(ref) == len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a["model_inputs"]["initial_context"] == b["model_inputs"]["initial_context"]
        np.testing.assert_array_equal(a["model_inputs"]["x"], b["model_inputs"]["x"])
    assert len(got[-1]["model_inputs"]["initial_context"]) == 3


# --- the benchmark's null embedding ---------------------------------------------------


def test_the_hard_configs_null_embedding_drops_like_jax(tmp_path):
    path = tmp_path / "null_embedding.npy"
    np.save(path, np.zeros((EMB_LEN, builder.EMB_DIM), np.float32))  # as write_shards saves it
    cfg = {**compose_config(CONFIGS, "train_hard_txt2img_mmdit")["embedder"], "path_null_embedding": str(path)}
    assert cfg["null_embedding_seq_len"] == 1
    ours = instantiate(cfg, device="cpu")
    ref = JaxPrecomputedEmbedder(path_null_embedding=str(path), null_embedding_seq_len=1)
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((3, EMB_LEN, builder.EMB_DIM)).astype(np.float32)
    mask = np.ones((3, EMB_LEN), bool)
    mask[:, 6:] = False
    drop = np.array([False, True, False])
    out = ours({"embeddings": torch.from_numpy(emb), "attn_mask": torch.from_numpy(mask)}, torch.from_numpy(drop))
    want = ref({"embeddings": jnp.asarray(emb), "attn_mask": jnp.asarray(mask)}, jnp.asarray(drop))
    np.testing.assert_array_equal(out["embeddings"].numpy(), np.asarray(want["embeddings"]))
    np.testing.assert_array_equal(out["attn_mask"].numpy(), np.asarray(want["attn_mask"]))
    assert not out["embeddings"][1].any() and out["attn_mask"][1].tolist() == [True] + [False] * (EMB_LEN - 1)


# --- the tower: one step, the statistics, the shards ----------------------------------


def test_tower_step_matches_jax(towers):
    jax_tower, tower = towers
    tower = Flux2VAE(**TINY_TOWER, device="cpu")
    tower.load_state_dict(towers[1].state_dict(), strict=True)  # a copy: the step moves it
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 8, 8, TINY_TOWER["latent_channels"])).astype(np.float32)
    graphdef, params, rest = nnx.split(jax_tower, nnx.Param, ...)

    def loss_fn(params):  # build_hard_txt2img.py:69-78, the draw injected
        t = nnx.merge(graphdef, params, rest)
        mean, logvar = jnp.split(t.encoder(jnp.asarray(x)), 2, axis=-1)
        logvar = jnp.clip(logvar, -30.0, 20.0)
        z = mean + jnp.exp(0.5 * logvar) * jnp.asarray(noise)
        mse = jnp.mean((t.decoder(z) - x) ** 2)
        kl = 0.5 * jnp.mean(mean ** 2 + jnp.exp(logvar) - 1.0 - logvar)
        return mse + KL_WEIGHT * kl, (mse, kl)

    (ref_loss, (ref_mse, ref_kl)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    opt = optax.adamw(1e-3)
    updates, _ = opt.update(grads, opt.init(params), params)
    ref_new = state_dict_from_jax(_flat(optax.apply_updates(params, updates)), tower)
    ref_grads = state_dict_from_jax(_flat(grads), tower)

    loss, mse, kl = builder.tower_loss(tower, torch.from_numpy(x), torch.from_numpy(noise), KL_WEIGHT)
    for ours, ref in ((loss, ref_loss), (mse, ref_mse), (kl, ref_kl)):
        assert abs(float(ours) - float(ref)) <= 1e-5 * abs(float(ref))
    loss.backward()
    # a conv bias feeding a GroupNorm has a zero gradient in exact arithmetic (~1e-9 here on both sides):
    # each gradient's error is taken against its own largest entry, at least 1e-3 of the largest of all
    floor = 1e-3 * max(float(ref_grads[name].abs().max()) for name, _ in tower.named_parameters())
    for name, p in tower.named_parameters():
        ref = ref_grads[name].numpy()
        err = float(np.max(np.abs(p.grad.numpy() - ref))) / max(float(np.max(np.abs(ref))), floor)
        assert err < 1e-4, (name, err)
    # the update rule on the same gradients (Adam divides the near-zero ones by ~eps, so the step's own
    # gradients would compare their rounding): the JAX gradients through the builder's AdamW
    optimizer = torch.optim.AdamW(tower.parameters(), lr=1e-3, **builder.ADAMW)
    for name, p in tower.named_parameters():
        p.grad = ref_grads[name].clone()
    optimizer.step()
    for name, p in tower.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_new[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
    step_mse, step_kl = builder.tower_step(tower, optimizer, torch.from_numpy(x), torch.from_numpy(noise), KL_WEIGHT)
    _, mse_after, kl_after = builder.tower_loss(tower, torch.from_numpy(x), torch.from_numpy(noise), KL_WEIGHT)
    assert float(step_mse) != float(mse_after) and np.isfinite([float(step_mse), float(step_kl)]).all()


def test_latent_statistics_and_shards_match_jax(towers, tmp_path):
    jax_tower, tower = towers
    jax_builder = _load_script("build_hard_txt2img")
    table = caption_embedding_table(builder.EMB_DIM)
    kw = dict(batch=4, n_train=6, n_val=4, image_size=16, seed=1)
    jax_builder.write_shards(tmp_path / "jax", jax_tower, table, **kw)
    sizes = builder.write_shards(tmp_path / "port", tower, table, **kw)
    assert set(sizes) == {"train", "val"} and all(v > 0 for v in sizes.values())
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "null_embedding.npy"),
                                  np.load(tmp_path / "jax" / "null_embedding.npy"))
    for split, n in (("train", 6), ("val", 4)):
        ours, ref = ShardedDataset(tmp_path / "port" / split), JaxShardedDataset(tmp_path / "jax" / split)
        assert len(ours) == len(ref) == n
        lat = np.stack([ours[i]["vision_latents"] for i in range(n)])
        ref_lat = np.stack([ref[i]["vision_latents"] for i in range(n)])
        assert lat.shape == (n, 4, 4, 4 * TINY_TOWER["latent_channels"]) and rel_err(lat, ref_lat) < 1e-4
        for i in range(n):
            assert set(ours[i]) == set(ref[i]) == {"vision_latents", "caption", "caption_embeddings", "caption_mask",
                                                   "label"}
            assert str(ours[i]["caption"]) == str(ref[i]["caption"]) and int(ours[i]["label"]) == int(ref[i]["label"])
            for col in ("caption_embeddings", "caption_mask"):
                np.testing.assert_array_equal(ours[i][col], ref[i][col])
        mean, std = builder.latent_stats(lat)
        ref_mean, ref_std = ref_lat.mean(axis=(0, 1, 2)), ref_lat.std(axis=(0, 1, 2))
        assert rel_err(mean.ravel(), ref_mean) < 1e-4 and rel_err(std.ravel(), ref_std) < 1e-4


# --- the tower directory: the port's builder, the importer ---------------------------


def test_the_builder_tower_restores_through_flax_ckpt(tmp_path):
    images = builder.SyntheticCompositionalDataset(train=True, n_samples=8, image_size=16, seed=0).images
    tower = builder.train_tower(tmp_path, images, epochs=1, batch=4, lr=1e-3, kl_weight=1e-5, seed=0,
                                device=torch.device("cpu"))
    again = Flux2VAE(**builder.TOWER_KW, flax_ckpt=tmp_path / "tower", device="cpu")
    for (name, a), b in zip(tower.state_dict().items(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    mean, std = builder.latent_stats(builder.encode_all(again, builder.to_pm1(images), 4))
    torch.testing.assert_close(again.latent_scale, torch.from_numpy(1.0 / np.maximum(std, 1e-4)), rtol=1e-6, atol=0)
    torch.testing.assert_close(again.latent_bias, torch.from_numpy(mean), rtol=1e-6, atol=1e-7)


def test_the_importer_brings_a_jax_tower_to_flax_ckpt(towers, tmp_path):
    jax_tower, _ = towers
    rng = np.random.default_rng(7)
    scale = rng.uniform(0.5, 2.0, (1, 1, 1, 16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((1, 1, 1, 16))).astype(np.float32)
    jax_save_checkpoint(tmp_path / "jax_tower", {"encoder": nnx.state(jax_tower.encoder),
                                                 "decoder": nnx.state(jax_tower.decoder),
                                                 "latent_scale": scale, "latent_bias": bias})
    with pytest.raises(ValueError, match="import_orbax_checkpoint"):
        Flux2VAE(**TINY_TOWER, flax_ckpt=tmp_path / "jax_tower", device="cpu")
    importer = _load_script("import_orbax_checkpoint")
    result = importer.main([str(tmp_path / "jax_tower"), str(tmp_path / "tower"), "--tower-kw",
                            '{"base_channels": 16, "ch_mult": [1, 2], "num_res_blocks": 1, "latent_channels": 4}'])
    assert result["kind"] == "tower"
    tower = Flux2VAE(**TINY_TOWER, flax_ckpt=tmp_path / "tower", device="cpu")
    np.testing.assert_array_equal(tower.latent_scale.numpy(), scale)
    np.testing.assert_array_equal(tower.latent_bias.numpy(), bias)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        z = tower.encode(torch.from_numpy(x))
        rec = tower.decode(z)
    ref_z = jax_tower.encode(jnp.asarray(x))
    assert rel_err(z.numpy(), np.asarray(ref_z)) < 1e-4
    assert rel_err(rec.numpy(), np.asarray(jax_tower.decode(ref_z))) < 1e-4


@pytest.mark.parametrize("entry", ["denoiser", "ema"])
def test_the_importer_brings_a_jax_run_entry_to_the_port(tmp_path, entry):
    jax_model, params = randomized_jax_mmdit("fp32", seed=8)
    modules = _TrainModules(jax_model, [])
    _, jparams, _, rest = nnx.split(modules, jax_trainable_filter(jax_model), nnx.RngState, ...)
    payload = {"params": jparams} if entry == "ema" else {"params": jparams, "rest": rest}
    jax_save_checkpoint(tmp_path / "jax" / entry, payload)
    importer = _load_script("import_orbax_checkpoint")
    result = importer.main([str(tmp_path / "jax" / entry), str(tmp_path / "port" / entry)])
    assert result["kind"] == "run"
    if entry == "denoiser":
        assert sorted(p.rsplit("/", 1)[-1] for p in result["dropped"]) == ["null_embedding", "null_embedding_mask"]
    model = port_mmdit("fp32", {k: np.zeros_like(v) for k, v in params.items()})
    restore_train_modules(tmp_path / "port" / entry, model)
    want = state_dict_from_jax(params, model)
    for name, value in model.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=0, msg=name)


def test_only_the_importer_reads_orbax_and_it_imports_nothing_of_the_jax_package():
    from test_torch_port_dit import _imported_roots

    files = sorted((ROOT / "diffulab_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert ROOT / "diffulab_tpu_torch" / "scripts" / "build_hard_txt2img.py" in files
    for f in files:
        assert not {n.split(".")[0] for n in _imported_roots(f)} & {"orbax", "tensorstore"}, f
    roots = {n.split(".")[0] for n in _imported_roots(ROOT / "scripts" / "import_orbax_checkpoint.py")}
    assert "orbax" in roots and "diffulab_tpu_torch" in roots
    assert not roots & {"diffulab_tpu", "jax", "flax", "optax"}
