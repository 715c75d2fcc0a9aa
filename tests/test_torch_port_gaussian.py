"""The port's Gaussian (DDPM) formalization against the JAX package on the
CPU: diffulab_tpu_torch.diffuse.{schedules,gaussian_diffusion} and
.samplers.gaussian.

- the beta schedules, ``space_timesteps`` and ``respace_betas``, exactly;
- one step of each sampler (DDPM, DDIM at eta 0 and 0.5, DPM-Solver++(2M),
  UniPC; the multistep ones three steps in a row, so that their history is
  used) on seeded inputs, the stochastic draws injected (trap T4): every
  returned tensor at atol/rtol 1e-5;
- ``compute_loss`` for the epsilon, xstart and v heads, min-SNR weighting and
  the learned-range hybrid VLB, with t, noise and the drop mask injected, on
  a tiny class-conditional UNet with bridged weights: rel 1e-5, and the
  epsilon loss's gradients;
- the slice as a whole: DDIM-10 and DDPM-10 ``generate`` (respaced from 1000
  training steps) with CFG, with and without one DeepCache span, the
  reference's scan draws replayed into ``draw_noise``: the trajectory
  (``xt``, ``xt_mean``, ``xt_std``, ``logprob``) at rel 5e-5 (max |port -
  JAX| over max |JAX|), the x0 estimates and the final sample at rel 5e-4:
  one UNet forward differs from JAX's by about 2e-6 relative (its convs sum
  in another order), and x0 = (x_t - sqrt(1 - ab) eps) / sqrt(ab) multiplies
  that by up to 1 / sqrt(ab) = 157 at t = 999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import _randomize, injected, jax_scan_noise, rel_err
from flax import nnx

import diffulab_tpu.diffuse.schedules as jax_sched
from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.diffuse.gaussian_diffusion import GaussianDiffusion as JaxGaussian
from diffulab_tpu.networks.denoisers.unet import UNetModel as JaxUNet
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.diffuse import schedules
from diffulab_tpu_torch.diffuse.gaussian_diffusion import GaussianDiffusion
from diffulab_tpu_torch.networks.denoisers.unet import UNetModel
from diffulab_tpu_torch.weights import state_dict_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
#: a tiny class-conditional UNet on 8x8x3: 2 levels of 32 / 64 channels, attention at ds 2 and the middle
UNET = dict(image_size=[8, 8], in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1,
            attention_resolutions=[2], channel_mult="1, 2", num_heads=2, resblock_updown=True,
            use_scale_shift_norm=True, n_classes=10, classifier_free=True)
SHAPE = (2, 8, 8, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _unet_pair(seed=0, **overrides):
    cfg = {**UNET, **overrides}
    jm = JaxUNet(**cfg, rngs=nnx.Rngs(0))
    params = _randomize(jm, seed)
    tm = UNetModel(**cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, tm), strict=True)
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _unet_pair(31)


# --- schedules ------------------------------------------------------------------


@pytest.mark.parametrize("schedule,n", [("linear", 1000), ("linear", 100), ("cosine", 1000)])
def test_variance_schedules_match_jax(schedule, n):
    ours = schedules.get_variance_schedule(n, schedule)
    assert ours.dtype == np.float64
    np.testing.assert_array_equal(ours, jax_sched.get_variance_schedule(n, schedule))


@pytest.mark.parametrize("n,counts,ddim", [(1000, 50, True), (1000, 10, True), (100, 25, True), (1000, 50, False),
                                           (1000, "10,15,20", False), (1000, 1, False), (250, "3,7", False)])
def test_space_timesteps_and_respace_betas_match_jax(n, counts, ddim):
    use = schedules.space_timesteps(n, counts, ddim=ddim)
    assert use == jax_sched.space_timesteps(n, counts, ddim=ddim)
    betas = schedules.get_variance_schedule(n)
    ours, ours_map = schedules.respace_betas(betas, use)
    ref, ref_map = jax_sched.respace_betas(betas, use)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours_map, ref_map)
    assert ours_map.dtype == np.int32


def test_space_timesteps_refuses_what_the_reference_refuses():
    for args in ((1000, 600, True), (10, "20", False)):
        with pytest.raises(ValueError):
            jax_sched.space_timesteps(*args[:2], ddim=args[2])
        with pytest.raises(ValueError):
            schedules.space_timesteps(*args[:2], ddim=args[2])


def test_extract_into_tensor_rounds_the_table_to_fp32_before_the_gather():
    table = np.cumprod(1 - schedules.get_variance_schedule(1000))
    t = np.array([0, 17, 999], np.int32)
    ours = schedules.extract_into_tensor(table, torch.from_numpy(t), 4)
    assert ours.shape == (3, 1, 1, 1) and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_sched.extract_into_tensor(table, jnp.asarray(t), 4)))


# --- one step of each sampler -------------------------------------------------------


@pytest.mark.parametrize("method,params", [("ddpm", {}), ("ddpm", {"var_type": "fixed_large"}),
                                           ("ddim", {}), ("ddim", {"eta": 0.5}), ("dpmpp_2m", {}), ("unipc", {})])
def test_sampler_steps_match_jax(method, params):
    ours_diff = GaussianDiffusion(sampling_method=method, sampler_parameters=params).set_steps(10)
    ref_diff = JaxGaussian(sampling_method=method, sampler_parameters=params).set_steps(10)
    ours, ref = ours_diff.sampler, ref_diff.sampler
    rng = np.random.default_rng(41)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    multistep = getattr(ours, "is_multistep", False)
    s_ours = ours.init_state(torch.from_numpy(x)) if multistep else None
    s_ref = ref.init_state(jnp.asarray(x)) if multistep else None
    for t in (9, 8, 0) if multistep else (9, 0):
        pred = rng.standard_normal(SHAPE).astype(np.float32)
        ts = np.full((SHAPE[0],), t, np.int32)
        key = jax.random.key(t)
        noise = np.asarray(jax.random.normal(key, SHAPE, jnp.float32))
        extra_ref = {"state": s_ref} if multistep else {}
        extra_ours = {"state": s_ours} if multistep else {}
        r = ref.step(jnp.asarray(pred), jnp.asarray(ts), jnp.asarray(x), rng=key, clamp_x=t == 0, **extra_ref)
        o = ours.step(torch.from_numpy(pred), torch.from_numpy(ts).long(), torch.from_numpy(x),
                      noise=torch.from_numpy(noise), clamp_x=t == 0, **extra_ours)
        s_ref, s_ours = r.pop("state", None), o.pop("state", None)
        assert set(o) == set(r), (set(o), set(r))
        for name in r:
            np.testing.assert_allclose(o[name].numpy(), np.broadcast_to(np.asarray(r[name]), o[name].shape),
                                       err_msg=f"{name} at t={t}", **TOL)
        if multistep:  # the state's tensors, and its host-side history depth
            for name, value in s_ref.items():
                if name in ("has_prev", "n_prev"):
                    assert s_ours[name] == (bool(value) if name == "has_prev" else int(value))
                else:
                    np.testing.assert_allclose(s_ours[name].numpy(), np.asarray(value), err_msg=name, **TOL)
        x = np.asarray(r["x_prev"], np.float32)


# --- the loss ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [{}, {"prediction_type": "xstart"}, {"prediction_type": "v"},
                                    {"loss_weighting": "min_snr"}, {"prediction_type": "v", "loss_weighting": "min_snr"},
                                    {"sampler_parameters": {"var_type": "learned_range"}}],
                         ids=["epsilon", "xstart", "v", "min_snr", "v_min_snr", "hybrid_vlb"])
def test_compute_loss_matches_jax(kwargs):
    learned = "sampler_parameters" in kwargs
    jm, tm = _unet_pair(32, out_channels=6) if learned else _unet_pair(31)
    rng = np.random.default_rng(42)
    x0 = np.clip(rng.standard_normal(SHAPE), -1, 1).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([0, 613], np.int32)  # t = 0 takes the VLB's discretised NLL
    y, drop = np.array([3, 7]), np.array([False, True])
    ours = GaussianDiffusion(**kwargs).compute_loss(
        lambda **kw: tm(**kw, train=True), torch.from_numpy(x0), {"y": torch.from_numpy(y)}, torch.from_numpy(t),
        torch.from_numpy(noise), drop=torch.from_numpy(drop))
    ref = JaxGaussian(**kwargs).compute_loss(
        lambda **kw: jm(**kw, train=True), jnp.asarray(x0), {"y": jnp.asarray(y)}, jnp.asarray(t),
        jnp.asarray(noise), drop=jnp.asarray(drop))
    assert set(ours) == set(ref) == ({"loss", "vlb"} if learned else {"loss"})
    for name in ref:
        assert abs(float(ours[name]) - float(ref[name])) <= 1e-5 * abs(float(ref[name])), name


def test_epsilon_loss_gradients_match_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(43)
    x0, noise = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    t, y, drop = np.array([5, 900], np.int32), np.array([1, 2]), np.array([True, False])
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def jax_loss(p):
        m = nnx.merge(graphdef, p, rest)
        return JaxGaussian().compute_loss(lambda **kw: m(**kw, train=True), jnp.asarray(x0), {"y": jnp.asarray(y)},
                                          jnp.asarray(t), jnp.asarray(noise), drop=jnp.asarray(drop))["loss"]

    ref, ref_grads = jax.value_and_grad(jax_loss)(params)
    tm.zero_grad(set_to_none=True)
    loss = Diffuser(tm, "ddpm", model_type="gaussian_diffusion").compute_loss(
        torch.from_numpy(x0), {"y": torch.from_numpy(y)}, torch.from_numpy(t), torch.from_numpy(noise),
        drop=torch.from_numpy(drop))["loss"]
    loss.backward()
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    flat = {"/".join(str(p) for p in path): np.asarray(v.get_value()) for path, v in ref_grads.flat_state()}
    grads = state_dict_from_jax(flat, tm)
    floor = 1e-2 * max(float(g.abs().max()) for g in grads.values())  # see test_torch_port_unet.py
    for name, param in tm.named_parameters():
        err = float((param.grad - grads[name]).abs().max())
        assert err <= 1e-4 * max(float(grads[name].abs().max()), floor), (name, err)


def test_draw_timesteps_and_the_respaced_model_timesteps():
    g = GaussianDiffusion().set_steps(50)
    gen = torch.Generator().manual_seed(0)
    t = g.draw_timesteps(gen, 1000)
    assert t.min() >= 0 and t.max() < 50 and len(set(t.tolist())) == 50
    # the model sees training timesteps: the respaced index maps through timestep_map
    np.testing.assert_array_equal(g._map_timesteps(torch.arange(50)).numpy(),
                                  np.asarray(JaxGaussian().set_steps(50)._map_timesteps(jnp.arange(50))))


# --- the slice: full reverse processes ------------------------------------------------------


def _draws(method, start_key):
    """The reference's draws: DDPM takes one normal a step from the scan's splits."""
    return jax_scan_noise(start_key, 10, SHAPE, jnp.float32) if method == "ddpm" else {}


@pytest.mark.parametrize("cache", [None, (2, 3)], ids=["uncached", "deepcache"])
@pytest.mark.parametrize("method", ["ddim", "ddpm"])
def test_ten_step_generate_with_cfg_matches_jax(pair, method, cache):
    jm, tm = pair
    rng = np.random.default_rng(44)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    y = np.array([4, 9])
    key = jax.random.key(3)
    jd = JaxDiffuser(jm, method, model_type="gaussian_diffusion", n_steps=1000)
    td = Diffuser(tm, method, model_type="gaussian_diffusion", n_steps=1000)
    for d in (jd, td):
        d.set_steps(10)
        if cache:
            d.set_block_cache(cache[0], (cache[1], len(tm.input_blocks)))
    try:
        ref = jd.generate(key, {"y": jnp.asarray(y)}, x=jnp.asarray(x), guidance_scale=2.5, clamp_x=True,
                          return_intermediates=True)
        out = td.generate({"y": torch.from_numpy(y)}, x=torch.from_numpy(x), guidance_scale=2.5, clamp_x=True,
                          return_intermediates=True, device="cpu", draw_noise=injected(_draws(method, key)))
    finally:
        for d in (jd, td):
            d.set_block_cache(None)
    assert set(out) == set(ref)
    assert out["xt"].shape == (2, 11, *SHAPE[1:]) and out["estimated_x0"].shape == (2, 10, *SHAPE[1:])
    for name in ref:
        tol = 5e-4 if name in ("x", "estimated_x0") else 5e-5
        assert rel_err(out[name].numpy(), np.broadcast_to(np.asarray(ref[name]), out[name].shape)) < tol, name
