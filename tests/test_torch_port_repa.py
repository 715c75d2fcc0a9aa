"""Live-encoder REPA in the port against the JAX package, on the CPU:
``networks/repa/{common,vit,fixed}.py``, ``training/losses/{repa,build}.py``,
the MMDiT's and the UNet's feature capture, and the formalizations' extra
losses.

- the ViT forward with bridged weights (registers and LayerScale on), rel 1e-5;
- ``RepaLoss`` on a tiny DiT (with and without ``use_checkpoint``): the
  loss, its gradients on the captured tokens and on every parameter of the
  ``_TrainModules`` bundle (projector and denoiser, bridged by name from
  JAX's ``{denoiser, extra_losses}`` tree) against ``jax.grad``, at 1e-5
  relative (the parameter gradients: 1e-4 of the largest of their tensor,
  with a floor of 1e-2 of the largest of all, as in the UNet tests); the
  frozen encoder has no gradient on either side;
- feature capture at every index of a tiny DiT, a tiny multimodal MMDiT and
  a tiny UNet (the U-REPA flat order: input groups, middle, output groups),
  rel 1e-5; capture with block caching raises;
- ``build_extra_losses`` on each REPA config (the encoder cut to one block):
  the same modules as the JAX package's, the encoder weights to 1e-6; and the
  config's U-REPA index 17 landing on the ViT's 64 tokens;
- the slice: one ``compute_loss`` of ``train_synthetic_flow_repa`` (the DiT)
  and of ``train_synthetic_ddpm_repa`` (the UNet) at reduced depth and
  width, bridged weights and injected t, noise and drop (trap T4): the total
  and every entry of the loss dict at rel 1e-5, and the total's gradients on
  the bundle as above;
- the refusals the reference makes; the paths item 13b opened (DINO
  encoders, precomputed features, the resampler) build.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import TINY, _randomize, port_mmdit, randomized_jax_mmdit, rel_err
from flax import nnx

from diffulab_tpu.config.compose import compose_config as jax_compose
from diffulab_tpu.config.instantiate import instantiate as jax_instantiate
from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu.networks.denoisers.unet import UNetModel as JaxUNet
from diffulab_tpu.networks.repa.vit import ViTEncoder as JaxViTEncoder
from diffulab_tpu.training.losses.build import build_extra_losses as jax_build_extra_losses
from diffulab_tpu.training.losses.repa import RepaLoss as JaxRepaLoss
from diffulab_tpu.training.trainer import _TrainModules
from diffulab_tpu_torch.config import compose_config, instantiate
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.examples.train_diffusion import CONFIG_DIR
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.networks.denoisers.unet import UNetModel
from diffulab_tpu_torch.networks.repa import ViTEncoder
from diffulab_tpu_torch.networks.repa.common import REPA, bicubic_resize, normalize_imagenet
from diffulab_tpu_torch.training.checkpoint import TrainModules
from diffulab_tpu_torch.training.losses import RepaLoss, build_extra_losses
from diffulab_tpu_torch.weights import state_dict_from_jax

#: a tiny DiT on 8x8x3 images (16 tokens of width 64) and a ViT giving 16 tokens of width 32
DIT = {**TINY, "input_channels": 3}
UNET = dict(image_size=[8, 8], in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1,
            attention_resolutions=[2], channel_mult="1, 2", num_heads=2, resblock_updown=True,
            use_scale_shift_norm=True, n_classes=10, classifier_free=True)
VIT = dict(img_size=8, patch_size=2, embed_dim=32, depth=1, num_heads=2, seed=4321)
SHAPE = (2, 8, 8, 3)
#: the REPA configs' encoder cut to one block (the weights are still drawn as JAX draws them)
CUT_VIT = ["repa.encoder_args.depth=1"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(state) -> dict[str, np.ndarray]:
    return {"/".join(str(p) for p in path): np.asarray(v.get_value()) for path, v in state.flat_state()}


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    return x, t, np.array([3, 7]), np.array([False, True])


# --- the encoder ------------------------------------------------------------------------------


def test_vit_forward_matches_jax():
    kw = dict(img_size=16, patch_size=4, embed_dim=32, depth=2, num_heads=2, num_register_tokens=2, layerscale=True)
    jm = JaxViTEncoder(**kw, rngs=nnx.Rngs(0))
    params = _randomize(jm, 5)
    ours = ViTEncoder(**kw, device="cpu")
    ours.load_state_dict(state_dict_from_jax(params, ours), strict=True)
    x = np.random.default_rng(6).uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    ref = jm(jnp.asarray(x))
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    for key in ("patch_tokens", "cls"):
        assert out[key].shape == ref[key].shape
        assert rel_err(out[key].numpy(), np.asarray(ref[key])) <= 1e-5, key
    px = np.random.default_rng(7).uniform(0, 255, (2, 4, 4, 3)).astype(np.float32)
    from diffulab_tpu.networks.repa.common import normalize_imagenet as jax_normalize

    np.testing.assert_allclose(normalize_imagenet(torch.from_numpy(px)).numpy(), np.asarray(jax_normalize(px)),
                               rtol=1e-6, atol=1e-6)


# --- RepaLoss on the DiT and the UNet ------------------------------------------------------------


def _dit_pair(seed: int, **port_kw):
    """(JAX DiT, port DiT, JAX RepaLoss, port RepaLoss), randomised and
    bridged, each loss attached to its denoiser at the last block."""
    jm, tm = JaxMMDiT(**DIT, rngs=nnx.Rngs(0)), MMDiT(**DIT, **port_kw, device="cpu")
    tm.load_state_dict(state_dict_from_jax(_randomize(jm, seed), tm), strict=True)
    kw = dict(repa_encoder="fixed_vit", encoder_args=VIT, alignment_layer=2, denoiser_dimension=64, hidden_dim=48,
              coeff=0.5)
    jl = JaxRepaLoss(**kw, rngs=nnx.Rngs(2))
    tl = RepaLoss(**kw, device="cpu")
    tl.load_state_dict(state_dict_from_jax(_randomize(jl, seed + 1), tl), strict=True)
    jl.set_model(jm)
    tl.set_model(tm)
    assert tm.feature_layers == tuple(jm.feature_layers) == (1,)
    return jm, tm, jl, tl


def _check_bundle_grads(modules, ref_grads) -> None:
    """Every parameter's gradient of the port's TrainModules against the JAX
    _TrainModules' jax.grad tree, bridged by name."""
    grads = state_dict_from_jax(_flat(ref_grads), modules)
    assert set(grads) == {name for name, _ in modules.named_parameters()}
    floor = 1e-2 * max(float(g.abs().max()) for g in grads.values())
    for name, param in modules.named_parameters():
        if "repa_encoder" in name.split("."):  # the frozen target: no gradient on either side
            assert param.grad is None and float(grads[name].abs().max()) == 0.0, name
            continue
        grad = torch.zeros_like(param) if param.grad is None else param.grad  # not on the loss's path (JAX: 0)
        err = float((grad - grads[name]).abs().max())
        assert err <= 1e-4 * max(float(grads[name].abs().max()), floor), (name, err)


@pytest.mark.parametrize("port_kw", [{}, {"use_checkpoint": True}], ids=["dit", "dit_checkpoint"])
def test_repa_loss_and_gradients_match_jax(port_kw):
    jm, tm, jl, tl = _dit_pair(21, **port_kw)
    x, t, y, drop = _inputs(22)
    x0 = np.clip(x + 0.1, -1, 1).astype(np.float32)
    graphdef, params, rest = nnx.split(_TrainModules(jm, [jl]), nnx.Param, ...)
    args = dict(x=jnp.asarray(x), timesteps=jnp.asarray(t), cond={"y": jnp.asarray(y)}, drop=jnp.asarray(drop))

    def jax_loss(p):
        m = nnx.merge(graphdef, p, rest)
        out = m.denoiser(**args, train=True, capture_features=True)
        return m.extra_losses[0](out, x0=jnp.asarray(x0))

    ref, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    feats = jm(**args, train=True, capture_features=True)["features"]
    ref_feat_grads = jax.jit(jax.grad(lambda f: jl({"features": f}, x0=jnp.asarray(x0))))(feats)

    out = tm(x=torch.from_numpy(x), timesteps=torch.from_numpy(t), cond={"y": torch.from_numpy(y)},
             drop=torch.from_numpy(drop), train=True, capture_features=True)
    assert len(out["features"]) == 1 and out["features"][0].shape == feats[0].shape
    assert rel_err(out["features"][0].detach().numpy(), np.asarray(feats[0])) <= 1e-5
    loss = tl(out, x0=torch.from_numpy(x0))
    loss.backward()
    assert abs(loss.item() - float(ref)) <= 1e-5 * abs(float(ref))
    leaf = out["features"][0].detach().requires_grad_()
    (leaf_grad,) = torch.autograd.grad(tl({"features": [leaf]}, x0=torch.from_numpy(x0)), leaf)
    assert rel_err(leaf_grad.numpy(), np.asarray(ref_feat_grads[0])) <= 1e-5
    _check_bundle_grads(TrainModules(tm, [tl]), ref_grads)


#: the two configs at reduced depth and width: the DiT at depth 2 and width 64 (256 tokens), the UNet at
#: width 32 with two levels on 16x16 (attention at ds 2), REPA on the first ds-2 decoder group (8x8 tokens); the
#: encoder cut to one block, at 16x16 for the UNet
SLICE = {
    "train_synthetic_flow_repa": ["model.depth=2", "model.inner_dim=64", "model.embedding_dim=64", "model.num_heads=4",
                                  "repa.alignment_layer=2", *CUT_VIT],
    "train_synthetic_ddpm_repa": ["model.model_channels=32", "model.channel_mult=1, 2", "model.attention_resolutions=[2]",
                                  "model.image_size=[16, 16]", "repa.denoiser_dimension=64", "repa.alignment_layer=8",
                                  "repa.encoder_args.img_size=16", "repa.encoder_args.patch_size=2", *CUT_VIT],
}


@pytest.fixture(scope="module")
def slice_models():
    """(config, JAX denoiser, port denoiser) of a SLICE config, randomised and
    bridged, built once for the module."""
    built = {}

    def get(config):
        if config not in built:
            cfg = compose_config(CONFIG_DIR, config, SLICE[config])
            jm = jax_instantiate(cfg["model"], rngs=nnx.Rngs(0))
            tm = instantiate(cfg["model"], device="cpu")
            tm.load_state_dict(state_dict_from_jax(_randomize(jm, 41), tm), strict=True)
            built[config] = (cfg, jm, tm)
        return built[config]

    return get


# --- capture at every index -------------------------------------------------------------------------


def _jax_capture(jm, *args):
    """The JAX model's capturing forward, jitted (one compile in place of one per op)."""
    graphdef, state = nnx.split(jm)
    return jax.jit(lambda st, *a: nnx.merge(graphdef, st)(*a, capture_features=True))(state, *args)


def test_capture_at_every_index_matches_jax(slice_models):
    x, t, y, drop = _inputs(31)
    jdit = JaxMMDiT(**DIT, rngs=nnx.Rngs(0))
    dit = MMDiT(**DIT, device="cpu")
    dit.load_state_dict(state_dict_from_jax(_randomize(jdit, 32), dit), strict=True)
    _, junet, unet = slice_models("train_synthetic_ddpm_repa")  # 13 capture points, attention at ds 2
    ux = np.random.default_rng(33).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    cases = [(jdit, dit, {"y": y}, t), (junet, unet, {"y": y}, np.array([4, 900], np.int32), ux)]
    # the multimodal MMDiT (2 dual- and 1 single-stream block) on 4x4x4 latents and 8 text tokens
    from _torch_port_common import context_inputs

    jmm, mm_params = randomized_jax_mmdit("fp32", 34)
    mm = port_mmdit("fp32", mm_params)
    emb, mask = context_inputs(2)
    mm_x = np.random.default_rng(35).standard_normal((2, 4, 4, 4)).astype(np.float32)
    cases.append((jmm, mm, {"context": {"embeddings": emb, "attn_mask": mask}}, t, mm_x))
    for case in cases:
        jm, tm, cond, tt = case[:4]
        xx = case[4] if len(case) > 4 else x
        every = tuple(range(len(jm.layers)))
        assert len(tm.layers) == len(every)
        jm.feature_layers, tm.feature_layers = every, every
        ref = _jax_capture(jm, jnp.asarray(xx), jnp.asarray(tt), jax.tree.map(jnp.asarray, cond), jnp.asarray(drop))
        with torch.no_grad():
            out = tm(torch.from_numpy(xx), torch.from_numpy(tt), jax.tree.map(torch.as_tensor, cond),
                     torch.from_numpy(drop), capture_features=True)
        assert len(out["features"]) == len(ref["features"]) == len(every)
        for i, (got, want) in enumerate(zip(out["features"], ref["features"])):
            assert got.shape == want.shape, (type(tm).__name__, i)
            assert rel_err(got.numpy(), np.asarray(want)) <= 1e-5, (type(tm).__name__, i)
        assert rel_err(out["x"].numpy(), np.asarray(ref["x"])) <= 1e-5
        # only the listed points come back, in index order
        tm.feature_layers = (every[-1], 0)
        with torch.no_grad():
            picked = tm(torch.from_numpy(xx), torch.from_numpy(tt), jax.tree.map(torch.as_tensor, cond),
                        torch.from_numpy(drop), capture_features=True)["features"]
        assert [f.shape for f in picked] == [out["features"][0].shape, out["features"][-1].shape]
        jm.feature_layers, tm.feature_layers = (), ()


@pytest.mark.parametrize("kind", ["dit", "unet"])
def test_capture_and_block_caching_do_not_compose(kind):
    x, t, y, _ = _inputs(36)
    if kind == "unet":
        model, span, t = UNetModel(**UNET, device="cpu"), (1, 4), np.array([4, 9], np.int32)
    else:
        model, span = MMDiT(**DIT, device="cpu"), (0, 1)
    model.set_block_cache_span(span)
    cache = model.init_block_cache(SHAPE, {"y": torch.from_numpy(y)}, use_cfg=False)
    with pytest.raises(ValueError, match="don't compose"):
        model(torch.from_numpy(x), torch.from_numpy(t), {"y": torch.from_numpy(y)}, block_cache=cache,
              cache_refresh=True, capture_features=True)


# --- build_extra_losses on the configs ------------------------------------------------------------------


@pytest.mark.parametrize("config,dim,layer,tokens", [("train_synthetic_flow_repa", 512, 4, 256),
                                                     ("train_synthetic_edm_repa", 512, 4, 256),
                                                     ("train_synthetic_ddpm_repa", 384, 17, 64)])
def test_build_extra_losses_on_each_repa_config(config, dim, layer, tokens):
    cfg = compose_config(CONFIG_DIR, config, CUT_VIT)
    assert cfg == jax_compose(CONFIG_DIR, config, CUT_VIT)
    (loss,) = build_extra_losses(cfg, device="cpu")
    (ref,) = jax_build_extra_losses(cfg)
    assert isinstance(loss, RepaLoss) and isinstance(loss.repa_encoder, REPA)
    assert (loss.alignment_layer, loss.coeff, loss.proj_fc1.weight.shape[1]) == (layer, 0.5, dim)
    ours = dict(loss.named_parameters())
    want = state_dict_from_jax(_flat(nnx.state(ref, nnx.Param)), loss)
    assert set(ours) == set(want)
    for name, value in want.items():
        assert ours[name].shape == value.shape, name
        if "repa_encoder" in name:  # the JAX draw; the projector's init is the port's own
            assert float((ours[name].detach() - value).abs().max()) <= 1e-6, name
    # the projector's init is reproducible from the seed
    (again,) = build_extra_losses(cfg, device="cpu")
    assert torch.equal(again.proj_fc1.weight, loss.proj_fc1.weight)
    with torch.no_grad():
        feats = loss.repa_encoder(torch.zeros(1, 32, 32, 3))
    assert feats.shape == (1, tokens, 384)


def test_the_ddpm_repa_alignment_layer_is_the_first_ds4_decoder_group():
    """Index 17 (1-based) of the config's UNet (channel_mult 1,2,4,8, two
    res blocks) is the first decoder group at ds 4: 8x8 = 64 tokens at 4x
    model_channels, the FixedViT-S/4's token count (checked at width 32)."""
    cfg = compose_config(CONFIG_DIR, "train_synthetic_ddpm_repa", ["model.model_channels=32"])
    model = instantiate(cfg["model"], device="cpu")
    (loss,) = build_extra_losses({**cfg, "repa": {**cfg["repa"], "denoiser_dimension": 128}}, device="cpu")
    loss.set_model(model)
    assert model.feature_layers == (16,) and len(model.layers) == 25
    with torch.no_grad():
        out = model(torch.zeros(1, 32, 32, 3), torch.zeros(1, dtype=torch.long), {"y": torch.zeros(1, dtype=torch.long)},
                    capture_features=True)
    assert out["features"][0].shape == (1, 64, 128)


# --- the slice: one compute_loss per config --------------------------------------------------------------


@pytest.mark.parametrize("config", list(SLICE))
def test_slice_compute_loss_matches_jax(config, slice_models):
    """One compute_loss of the config, every entry of the loss dict and the
    gradients of their sum on the whole TrainModules bundle."""
    cfg, jm, tm = slice_models(config)
    (jl,) = jax_build_extra_losses(cfg)
    (tl,) = build_extra_losses(cfg, device="cpu")
    tl.load_state_dict(state_dict_from_jax(_randomize(jl, 42), tl), strict=True)
    d = cfg["diffuser"]
    jd = JaxDiffuser(jm, d["sampling_method"], model_type=d["model_type"], n_steps=d["n_steps"], extra_losses=[jl])
    td = Diffuser(tm, d["sampling_method"], model_type=d["model_type"], n_steps=d["n_steps"], extra_losses=[tl])
    jl.set_model(jm)
    tl.set_model(tm)
    rng = np.random.default_rng(43)
    size = cfg["model"].get("image_size", [32])[0]
    x0 = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = (np.array([0.25, 0.7], np.float32) if d["model_type"] == "rectified_flow" else np.array([3, 771], np.int32))
    y, drop = np.array([1, 8]), np.array([True, False])
    graphdef, params, rest = nnx.split(_TrainModules(jm, [jl]), nnx.Param, ...)

    def jax_losses(p):
        m = nnx.merge(graphdef, p, rest)
        losses = jd.diffusion.compute_loss(
            lambda **kw: m.denoiser(**kw, train=True, capture_features=True), jnp.asarray(x0), {"y": jnp.asarray(y)},
            jnp.asarray(t), jnp.asarray(noise), drop=jnp.asarray(drop), extra_losses=list(m.extra_losses))
        return sum(losses.values()), losses

    (ref_total, ref), ref_grads = jax.jit(jax.value_and_grad(jax_losses, has_aux=True))(params)
    ours = td.compute_loss(torch.from_numpy(x0), {"y": torch.from_numpy(y)}, torch.from_numpy(t),
                           torch.from_numpy(noise), drop=torch.from_numpy(drop))
    assert set(ours) == set(ref) == {"loss", "RepaLoss"}
    for name in ref:
        assert abs(ours[name].item() - float(ref[name])) <= 1e-5 * abs(float(ref[name])), name
    total = sum(ours.values())
    assert abs(total.item() - float(ref_total)) <= 1e-5 * abs(float(ref_total))
    total.backward()
    _check_bundle_grads(TrainModules(tm, [tl]), ref_grads)


# --- the refusals that stay, and the paths that item 13b opened ---------------------------------------------


def test_the_13b_paths_raise():
    """The refusals the reference makes (an unknown encoder, a resampler
    without parameters, an aligned width it cannot find, no captured
    features, a layer out of range, a loss with neither features nor an
    encoder, a dataset path that is not there) still raise; the paths of
    ROADMAP item 13b, which raised until slice G1, now build: the DINO
    encoders, precomputed features (``load_dino=False``) and the Perceiver
    resampler, through ``RepaLoss`` and ``build_extra_losses`` as in the JAX
    package (their numbers: tests/test_torch_port_repa_encoders.py and
    tests/test_torch_port_g1_cli.py)."""
    kw = dict(encoder_args=VIT, denoiser_dimension=64, device="cpu")
    dino = dict(dino_model="dinov2_vits14", target_seq_len=4)
    assert type(RepaLoss(repa_encoder="dinov2", denoiser_dimension=64, encoder_args=dino, device="meta").repa_encoder
                ).__name__ == "DinoV2"
    assert RepaLoss(repa_encoder="dinov3", denoiser_dimension=64, device="meta").repa_encoder.embedding_dim == 768
    precomputed = RepaLoss(repa_encoder="fixed_vit", load_dino=False, embedding_dim=24, alignment_layer=1, **kw)
    precomputed.set_model(MMDiT(**DIT, device="cpu"))
    assert precomputed.repa_encoder is None and precomputed.proj_fc3.weight.shape[0] == 24
    with pytest.raises(ValueError, match="Resampler parameters"):
        RepaLoss(repa_encoder="fixed_vit", use_resampler=True, **kw)
    resampled = RepaLoss(repa_encoder="fixed_vit", use_resampler=True, resampler_params=dict(dim=32, depth=1), **kw)
    assert resampled.resampler is not None and resampled.resampler.latents.shape == (16, 32)
    with pytest.raises(ValueError, match="not supported"):
        RepaLoss(repa_encoder="clip", **kw)
    cfg = {"model": {"inner_dim": 64}, "perceiver_resampler": {"use_resampler": True, "parameters": {}}}
    with pytest.raises(TypeError, match="dim"):  # the resampler's dim and depth have no defaults, as in JAX
        build_extra_losses(cfg, device="cpu")
    (loss,) = build_extra_losses({"model": {"inner_dim": 64}, "repa": {"embedding_dim": 384}}, device="cpu")
    assert loss.repa_encoder is None and loss.resampler is None and loss.proj_fc3.weight.shape == (384, 1024)
    with pytest.raises(ValueError, match="denoiser_dimension"):
        build_extra_losses({"model": {}, "repa": {"repa_encoder": "fixed_vit"}}, device="cpu")
    assert build_extra_losses({"model": {}}, device="cpu") == []
    assert bicubic_resize(torch.zeros(1, 4, 4, 3), 8).shape == (1, 8, 8, 3)
    with pytest.raises(FileNotFoundError):
        REPA().compute_on_dataset("a", "b")
    with pytest.raises(ValueError, match="no dst_features"):
        precomputed({"features": [torch.zeros(1, 16, 64)]}, x0=torch.zeros(1, 8, 8, 3))
    loss = RepaLoss(repa_encoder="fixed_vit", **kw)
    with pytest.raises(RuntimeError, match="no captured features"):
        loss({"x": torch.zeros(1)}, x0=torch.zeros(1, 8, 8, 3))
    with pytest.raises(ValueError, match="out of range"):
        RepaLoss(repa_encoder="fixed_vit", alignment_layer=3, **kw).set_model(MMDiT(**DIT, device="cpu"))
