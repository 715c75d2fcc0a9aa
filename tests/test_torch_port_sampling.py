"""The port's sampling path (diffulab_tpu_torch.diffuse) against the JAX package.

``Diffuser.generate`` runs 4 Euler steps with fused CFG at scale 4.0 on the
randomised tiny DiT; torch cannot reproduce JAX's random streams, so both
start from the same injected ``x`` (trap T4). Tolerances, as max |port - JAX|
over max |JAX|: 1e-5 in fp32 (measured ~7e-7), 4e-2 in bf16 (measured ~1.6%
for the whole-model cast). The unit tests below pin trap T8: JAX promotes a
bf16 tensor times an fp32 0-d array to fp32, torch would keep it bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import LATENT, POLICIES, TINY, port_model, randomized_jax_model, rel_err

from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.diffuse.flow import _cfg_model_call as jax_cfg_model_call
from diffulab_tpu.diffuse.guidance import combine_cfg as jax_combine_cfg
from diffulab_tpu.diffuse.guidance import effective_scale as jax_effective_scale
from diffulab_tpu.diffuse.samplers.flow import Euler as JaxEuler
from diffulab_tpu.diffuse.schedules import flow_linear_timesteps as jax_timesteps
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.diffuse.flow import Flow, _cfg_model_call
from diffulab_tpu_torch.diffuse.guidance import combine_cfg, effective_scale
from diffulab_tpu_torch.diffuse.samplers.flow import Euler
from diffulab_tpu_torch.diffuse.schedules import flow_linear_timesteps
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.networks.vision_towers import Flux2VAE

TOL = {"fp32": 1e-5, "bf16_full": 4e-2, "bf16_mixed": 4e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_generate_cfg_matches_jax(policy):
    jax_model, params = randomized_jax_model(policy, seed=3)
    model = port_model(policy, params)
    jdt = POLICIES[policy][0].get("dtype", jnp.float32)
    tdt = POLICIES[policy][1].get("dtype", torch.float32)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, *LATENT)).astype(np.float32)
    y = rng.integers(0, TINY["n_classes"], 3)

    ref = JaxDiffuser(jax_model, "euler", n_steps=4).generate(
        jax.random.key(0), {"y": jnp.asarray(y)}, x=jnp.asarray(x, jdt), guidance_scale=4.0, dtype=jdt,
    )["x"]
    out = Diffuser(model, "euler", n_steps=4).generate(
        {"y": torch.from_numpy(y)}, x=torch.from_numpy(x), guidance_scale=4.0, dtype=tdt, device="cpu",
    )["x"]
    assert out.dtype == tdt and out.shape == (3, *LATENT)
    assert rel_err(out.float().numpy(), np.asarray(ref, np.float32)) < TOL[policy]


def test_generate_draws_noise_from_the_generator():
    _, params = randomized_jax_model("fp32")
    diffuser = Diffuser(port_model("fp32", params), "euler", n_steps=2)
    cond = {"y": torch.tensor([1, 2])}

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return diffuser.generate(cond, data_shape=(2, *LATENT), generator=g, guidance_scale=4.0,
                                 device="cpu", clamp_x=True)["x"]

    a, b, c = run(0), run(0), run(1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert a.abs().max() <= 1.0


def _bf16_model_fn(out):
    """A model whose 2x-batch output is the fixed bf16 tensor ``out``."""
    def fn(x, timesteps, cond, drop):
        assert x.shape[0] == out.shape[0] and bool(drop[out.shape[0] // 2:].all())
        return {"x": out}
    return fn


def test_cfg_combine_promotes_to_fp32_like_jax():
    rng = np.random.default_rng(7)
    out = rng.standard_normal((4, 2, 2, 3)).astype(np.float32)
    x = np.zeros((2, 2, 2, 3), np.float32)
    t = np.full(2, 0.5, np.float32)
    ref = jax_cfg_model_call(_bf16_model_fn(jnp.asarray(out, jnp.bfloat16)), jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(t), {}, jnp.asarray(4.0, jnp.float32), True)
    ours = _cfg_model_call(_bf16_model_fn(torch.from_numpy(out).bfloat16()), torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(t), {}, 4.0, True)
    assert ref.dtype == jnp.float32 and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # the trap: the same expression left to torch's promotion stays bf16 and rounds
    cond, uncond = torch.from_numpy(out).bfloat16().chunk(2)
    naive = uncond + torch.tensor(4.0) * (cond - uncond)
    assert naive.dtype == torch.bfloat16
    assert not np.array_equal(naive.float().numpy(), np.asarray(ref))


def test_euler_step_runs_in_fp32_like_jax():
    rng = np.random.default_rng(8)
    x, v = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    ts = jax_timesteps(50)
    t_curr, t_prev = ts[3], ts[4]
    ref = JaxEuler().step(jnp.asarray(x, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                          jnp.asarray(t_curr), jnp.asarray(t_prev))
    ours = Euler().step(torch.from_numpy(x).bfloat16(), torch.from_numpy(v).bfloat16(), t_curr, t_prev)
    for key in ("x_prev", "estimated_x0"):
        assert ours[key].dtype == torch.float32 and ref[key].dtype == jnp.float32
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))


@pytest.mark.parametrize("shift", [None, 3.0])
def test_timestep_grid_matches_jax(shift):
    ours = flow_linear_timesteps(50, shift)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jax_timesteps(50, shift))
    np.testing.assert_array_equal(Flow(n_steps=50, shift=shift).timesteps, ours)


def test_guidance_interval_and_rescale_match_jax():
    rng = np.random.default_rng(9)
    cond, uncond = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32) for _ in range(2))
    level = np.array([0.02, 0.5, 0.9], np.float32)
    ours = combine_cfg(torch.from_numpy(cond), torch.from_numpy(uncond),
                       effective_scale(3.0, torch.from_numpy(level), (0.05, 0.75)), 0.7)
    ref = jax_combine_cfg(jnp.asarray(cond), jnp.asarray(uncond),
                          jax_effective_scale(jnp.asarray(3.0, jnp.float32), jnp.asarray(level), (0.05, 0.75)),
                          0.7)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_batch_utils_match_jax():
    from diffulab_tpu.utils import batch_broadcast as jax_broadcast
    from diffulab_tpu.utils import flatten_nonbatch_mean as jax_mean
    from diffulab_tpu_torch.utils import batch_broadcast, flatten_nonbatch_mean

    x = np.random.default_rng(10).standard_normal((3, 4, 5, 2)).astype(np.float32)
    assert tuple(batch_broadcast(torch.from_numpy(x[:, 0, 0, 0]), 4).shape) == jax_broadcast(jnp.asarray(x[:, 0, 0, 0]), 4).shape
    np.testing.assert_allclose(flatten_nonbatch_mean(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_mean(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


def test_generate_needs_a_device_without_cuda(monkeypatch):
    model = MMDiT(**TINY, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Diffuser(model, "euler", n_steps=2).generate({"y": torch.tensor([0])}, data_shape=(1, *LATENT))


def test_unported_sampling_features_raise():
    """Nothing of the sampling path raises any more. The GRPO loss is ported
    (tests/test_torch_port_grpo.py): it re-evaluates an Euler-Maruyama
    request's intermediates, here with the sampling weights (every ratio 1),
    and refuses a formalization other than the flow one. The samplers, EDM,
    the Gaussian formalization, block caching and the generate options are
    ported (tests/test_torch_port_{samplers,edm,gaussian,caching,guided}.py):
    each builds here and runs one request."""
    model = MMDiT(**TINY, device="cpu")
    cond = {"y": torch.tensor([0])}
    gen = torch.Generator().manual_seed(0)
    em = Diffuser(model, "euler_maruyama", n_steps=2)
    sampling = em.generate(cond, data_shape=(1, *LATENT), generator=gen, guidance_scale=2.0, device="cpu",
                           return_intermediates=True)
    with torch.no_grad():
        losses = em.compute_loss(None, cond, None, None, grpo=True, train=False, grpo_args=dict(
            sampling=sampling, advantages=torch.ones(1), indices=[1], guidance_scale=2.0, timestep_fraction=0.5))
    assert float(losses["ratio_dev"]) < 1e-4 and float(losses["clip_frac"]) == 0 and bool(torch.isfinite(losses["loss"]))
    with pytest.raises(ValueError, match="Flow"):
        Diffuser(model, "heun", model_type="edm", n_steps=2).compute_loss(None, cond, None, None, grpo=True)
    for sampler, model_type in (("heun", "rectified_flow"), ("heun", "edm"), ("ddim", "gaussian_diffusion")):
        diffuser = Diffuser(model, sampler, model_type=model_type, n_steps=1000 if sampler == "ddim" else 2)
        diffuser.set_steps(2)  # a Gaussian schedule respaces its 1000 training steps
        out = diffuser.generate(cond, data_shape=(1, *LATENT), generator=gen, guidance_scale=2.0, device="cpu")["x"]
        assert out.shape == (1, *LATENT) and bool(torch.isfinite(out).all())
    # latent mode is ported: the tower's latent scale and bias are taken over
    tower = Flux2VAE(base_channels=8, ch_mult=(1,), num_res_blocks=1, latent_channels=1, device="cpu")
    latent = Diffuser(model, "euler", vision_tower=tower)
    assert latent.diffusion.latent_diffusion and (latent.latent_scale, latent.latent_bias) == (1.0, 0.0)
    diffuser = Diffuser(model, "euler", n_steps=2)
    diffuser.set_block_cache(2, span=(0, 1))
    assert model.cache_span == (0, 1)
    known = torch.zeros(1, *LATENT)
    mask = torch.ones(1, *LATENT[:2], 1)
    for kwargs in (dict(inpaint={"known": known, "mask": mask}), dict(img2img={"init": known, "strength": 0.5}),
                   dict(return_intermediates=True), dict(guide_denoiser=model)):
        out = diffuser.generate(cond, data_shape=(1, *LATENT), generator=gen, guidance_scale=2.0, device="cpu",
                                **kwargs)
        assert out["x"].shape == (1, *LATENT) and bool(torch.isfinite(out["x"]).all())
    assert "xt" not in out  # the intermediates only when asked for
    diffuser.set_block_cache(None)
    assert model.cache_span is None
