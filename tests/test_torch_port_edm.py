"""The port's EDM formalization (diffulab_tpu_torch.diffuse.edm) and
non-leaky augmentation (diffulab_tpu_torch.diffuse.augment, the MMDiT's
``augment_embed``) against the JAX package.

- the Karras sigma grid, bit for bit;
- the lambda(sigma)-weighted loss at injected sigmas, noise and drop mask
  (fp32, rel err 1e-5), and its gradients;
- each sampler (heun, euler, dpmpp_2m, unipc) over a 6-step grid, with and
  without CFG, and Heun with ``s_churn`` > 0 at the reference's own churn
  draws (trap T4), fp32 at 1e-5 (max |port - JAX| over max |JAX|), the
  intermediates included; 18 Heun steps take 35 model calls;
- ``AugmentPipe.apply`` on the labels the JAX pipe drew gives the JAX pipe's
  output exactly, for flips, each rotation k in {1, 2, 3} and shifts; the
  labels the port draws have the reference's layout;
- the DiT with ``augment_dim = 6`` conditioned on augmentation labels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import LATENT, TINY, _randomize, injected, jax_scan_noise, rel_err
from flax import nnx

from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.diffuse.augment import AugmentPipe as JaxAugmentPipe
from diffulab_tpu.networks.denoisers.mmdit import MMDiT as JaxMMDiT
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.diffuse.augment import AUGMENT_DIM, AugmentPipe
from diffulab_tpu_torch.diffuse.edm import EDM
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.weights import state_dict_from_jax

AUG = dict(TINY, augment_dim=AUGMENT_DIM)
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    """The tiny DiT with augmentation conditioning, every parameter randomised."""
    jax_model = JaxMMDiT(**AUG, rngs=nnx.Rngs(0))
    params = _randomize(jax_model, 21)
    model = MMDiT(**AUG, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jax_model, model


def _inputs(seed=22, batch=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, *LATENT)).astype(np.float32), rng.integers(0, TINY["n_classes"], batch)


@pytest.mark.parametrize("n_steps", [1, 6, 18])
def test_karras_grid_matches_jax(n_steps):
    from diffulab_tpu.diffuse.edm import EDM as JaxEDM

    np.testing.assert_array_equal(EDM(n_steps=n_steps).timesteps, JaxEDM(n_steps=n_steps).timesteps)
    assert EDM(n_steps=n_steps).timesteps[-1] == 0.0


def test_loss_and_gradients_match_jax(pair):
    jax_model, model = pair
    x0, y = _inputs()
    rng = np.random.default_rng(23)
    sigma = np.exp(-1.2 + 1.2 * rng.standard_normal(3)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    drop = np.array([False, True, False])
    jd = JaxDiffuser(jax_model, "heun", model_type="edm", n_steps=STEPS)

    graphdef, params, rest = nnx.split(jax_model, nnx.Param, ...)

    def jax_loss(params):
        m = nnx.merge(graphdef, params, rest)
        return jd.diffusion.compute_loss(lambda **kw: m(**kw, train=True), jnp.asarray(x0), {"y": jnp.asarray(y)},
                                         jnp.asarray(sigma), jnp.asarray(noise), drop=jnp.asarray(drop))["loss"]

    ref, ref_grads = jax.value_and_grad(jax_loss)(params)
    diffuser = Diffuser(model, "heun", model_type="edm", n_steps=STEPS)
    model.zero_grad(set_to_none=True)
    loss = diffuser.diffusion.compute_loss(diffuser.model_fn(train=True), torch.from_numpy(x0),
                                           {"y": torch.from_numpy(y)}, torch.from_numpy(sigma),
                                           torch.from_numpy(noise), drop=torch.from_numpy(drop))["loss"]
    loss.backward()
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    flat = {"/".join(str(p) for p in path): np.asarray(v.get_value()) for path, v in ref_grads.flat_state()}
    grads = state_dict_from_jax(flat)
    live = dict(model.named_parameters())
    for name, g in grads.items():
        if live[name].grad is None:  # augment_embed, off the path without labels: JAX's gradient is 0
            assert name.startswith("augment_embed") and not g.any(), name
            continue
        assert rel_err(live[name].grad.numpy(), g.numpy()) < 1e-4, name


@pytest.mark.parametrize("guidance", [0.0, 2.0])
@pytest.mark.parametrize("sampler", ["heun", "euler", "dpmpp_2m", "unipc"])
def test_sampler_trajectory_matches_jax(pair, sampler, guidance):
    jax_model, model = pair
    x, y = _inputs()
    x = 80.0 * x
    ref = JaxDiffuser(jax_model, sampler, model_type="edm", n_steps=STEPS).generate(
        jax.random.key(0), {"y": jnp.asarray(y)}, x=jnp.asarray(x), guidance_scale=guidance,
        return_intermediates=True)
    out = Diffuser(model, sampler, model_type="edm", n_steps=STEPS).generate(
        {"y": torch.from_numpy(y)}, x=torch.from_numpy(x), guidance_scale=guidance, device="cpu",
        return_intermediates=True)
    assert set(out) == set(ref) == {"x", "xt", "estimated_x0"}
    assert out["xt"].shape == (3, STEPS + 1, *LATENT) and out["estimated_x0"].shape == (3, STEPS, *LATENT)
    for name in ref:
        assert rel_err(out[name].numpy(), np.asarray(ref[name])) < 1e-5, name


def test_stochastic_churn_matches_jax_at_its_draws(pair):
    jax_model, model = pair
    x, y = _inputs(24)
    x = 80.0 * x
    extra = {"s_churn": 40.0, "s_noise": 1.003}
    key = jax.random.key(25)
    ref = JaxDiffuser(jax_model, "heun", model_type="edm", n_steps=STEPS, extra_args=extra).generate(
        key, {"y": jnp.asarray(y)}, x=jnp.asarray(x), guidance_scale=1.5)["x"]
    draws = jax_scan_noise(key, STEPS - 1, x.shape, jnp.float32, kind="churn")
    out = Diffuser(model, "heun", model_type="edm", n_steps=STEPS, extra_args=extra).generate(
        {"y": torch.from_numpy(y)}, x=torch.from_numpy(x), guidance_scale=1.5, device="cpu",
        draw_noise=injected(draws))["x"]
    assert rel_err(out.numpy(), np.asarray(ref)) < 1e-5
    plain = Diffuser(model, "heun", model_type="edm", n_steps=STEPS).generate(
        {"y": torch.from_numpy(y)}, x=torch.from_numpy(x), guidance_scale=1.5, device="cpu")["x"]
    assert float((plain - out).abs().max()) > 1e-4


def test_heun_18_takes_35_model_calls(pair):
    _, model = pair
    calls = []
    diffuser = Diffuser(model, "heun", model_type="edm", n_steps=18)
    original = diffuser.model_fn

    def counting(train=False):
        fn = original(train)

        def wrapped(**kw):
            calls.append(kw["x"].shape[0])
            return fn(**kw)
        return wrapped

    diffuser.model_fn = counting
    out = diffuser.generate({"y": torch.tensor([1, 2])}, data_shape=(2, *LATENT), guidance_scale=1.5,
                            generator=torch.Generator().manual_seed(0), device="cpu", clamp_x=True)["x"]
    assert calls == [4] * 35 and bool(torch.isfinite(out).all()) and float(out.abs().max()) <= 1.0


# --- augmentation ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_augment_apply_matches_the_jax_pipe(dtype):
    rng = np.random.default_rng(26)
    x = rng.standard_normal((64, 8, 8, 3)).astype(np.float32)
    out, labels = JaxAugmentPipe(p=0.5)(jax.random.key(27), jnp.asarray(x, dtype))
    labels = np.asarray(labels)
    # the draw covers every transform: flips, each rotation k and shifts, alone and together
    k = np.round(np.arctan2(labels[:, 2], labels[:, 1]) / (np.pi / 2)).astype(int) % 4
    rotated = np.abs(labels[:, 1]) + np.abs(labels[:, 2]) > 0.5
    assert set(k[rotated]) == {1, 2, 3} and (labels[:, 0] == 1).any() and (labels[:, 3] != 0).any()
    assert ((labels[:, 0] == 1) & ~rotated & (labels[:, 3] == 0) & (labels[:, 4] == 0)).any()  # a flip alone
    assert (labels[:, 5] == 0).any()
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ours = AugmentPipe.apply(torch.from_numpy(x).to(tdt), torch.from_numpy(labels))
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(out, np.float32))


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_augment_rotations_follow_numpy_rot90(k):
    x = torch.arange(2 * 4 * 4 * 1, dtype=torch.float32).reshape(2, 4, 4, 1)
    theta = k * np.pi / 2
    labels = torch.tensor([[0.0, np.cos(theta), np.sin(theta), 0.0, 0.0, 1.0]] * 2, dtype=torch.float32)
    if k == 0:
        labels[:, 1:3] = 0
    out = AugmentPipe.apply(x, labels)
    np.testing.assert_array_equal(out.numpy(), np.rot90(x.numpy(), k, axes=(1, 2)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jnp.rot90(jnp.asarray(x.numpy()), k, (1, 2))))


def test_augment_labels_have_the_reference_layout():
    x = torch.zeros(512, 8, 8, 3)
    out, labels = AugmentPipe(p=0.3)(x, torch.Generator().manual_seed(0))
    assert labels.shape == (512, AUGMENT_DIM) and labels.dtype == torch.float32 and out.shape == x.shape
    flip, cos, sin, tx, ty, applied = labels.T
    rotated = (cos.abs() + sin.abs()) > 0.5
    shifted = (tx != 0) | (ty != 0)
    # every visible transform sets the applied bit (a translation may draw a zero shift)
    assert bool((applied > 0)[(flip > 0) | rotated | shifted].all()) and set(applied.tolist()) == {0.0, 1.0}
    assert set(flip.tolist()) <= {0.0, 1.0} and tx.abs().max() <= 1 / 8 and ty.abs().max() <= 1 / 8
    assert 0.2 < float(flip.mean()) < 0.4 and 0.2 < float(rotated.float().mean()) < 0.4
    with pytest.raises(ValueError, match="square"):
        AugmentPipe()(torch.zeros(1, 4, 8, 3))


def test_augment_conditioned_forward_matches_jax(pair):
    jax_model, model = pair
    x, y = _inputs(28)
    aug = np.asarray(JaxAugmentPipe(p=0.5)(jax.random.key(29), jnp.zeros((3, 8, 8, 3)))[1])
    t = np.array([0.2, -0.5, 1.1], np.float32)
    drop = np.array([False, False, True])
    ref = jax_model(jnp.asarray(x), jnp.asarray(t), {"y": jnp.asarray(y), "augment_labels": jnp.asarray(aug)},
                    jnp.asarray(drop))["x"]
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    {"y": torch.from_numpy(y), "augment_labels": torch.from_numpy(aug)},
                    torch.from_numpy(drop))["x"]
        zero = model(torch.from_numpy(x), torch.from_numpy(t),
                     {"y": torch.from_numpy(y), "augment_labels": torch.zeros(3, AUGMENT_DIM)},
                     torch.from_numpy(drop))["x"]
        plain = model(torch.from_numpy(x), torch.from_numpy(t), {"y": torch.from_numpy(y)}, torch.from_numpy(drop))["x"]
    assert rel_err(out.numpy(), np.asarray(ref)) < 1e-5
    torch.testing.assert_close(zero, plain, rtol=0, atol=0)  # the zero label is the clean path
    assert float((out - plain).abs().max()) > 1e-5
    fresh = MMDiT(**AUG, device="cpu")
    assert float(fresh.augment_embed.weight.abs().max()) == 0.0 and fresh.augment_embed.bias is None
