"""The ADM UNet in bf16 (``trainer.precision_type=bf16``: compute dtype bf16,
fp32 master parameters) against the JAX UNet at the same policy on the CPU,
at a toy width that still attends at the UNets' head dims: 8x8 images, two
resolutions (``channel_mult`` 1, 2), attention at ds 2 (16 tokens) with one
head of 192 (``model_channels`` 96) or of 256 (128), so that the attention
runs at one of ``VALID_ROWS_HEAD_DIMS``: on the CPU the plain version of the
bf16 K1/K2 instances, which no longer refuse bf16 there.

The policy checked on both sides: GroupNorm32 in fp32, the time embedding,
FiLM and the residual stream in fp32 (``stable_dtype``), the convs and the
linears in bf16 with fp32 accumulation, q/k/v cast to bf16 for the
attention, the model's output in bf16 (the out conv's dtype). The JAX parameters are seeded noise
(the out convs are zero-initialised), bridged by ``state_dict_from_jax``.

Tolerances: a bf16 UNet rounds every conv and linear to bf16 on both sides,
in other sums; the forward within 2e-2 of the largest |JAX| value; the
epsilon loss within 2e-2 relative, each parameter's gradient within 6e-2 of
its norm (``rel_err``, as ``tests/test_torch_port_training.py`` holds the
bf16 DiT's). One AdamW step (``train_step``, the step ``BaseTrainer.train``
runs) on the fp32 masters: Adam's first update is ``lr·g/(|g| + eps)``
elementwise less the decay, about ``lr·sign(g)``, so a gradient of rounding
noise (a key bias's, which the softmax cancels) may step either way; where
both sides' gradients agree to 10% and exceed 1e-6, which is at least 80% of
the elements, the updated parameters agree within 2.5e-5 (lr 1e-3).

The Gaussian diffusion on a bf16 model's output: a DDIM and a DDPM step and
the epsilon loss, fed the same bf16 prediction on both sides (a stub model),
promote it to fp32 as the reference does, within 1e-5: a whole request of the
random-weight UNet would compare two bf16 trajectories that part through
1/sqrt(alpha_bar) (157 at t = 999), not the sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_port_common import _randomize, rel_err
from flax import nnx

from diffulab_tpu.diffuse import Diffuser as JaxDiffuser
from diffulab_tpu.diffuse.gaussian_diffusion import GaussianDiffusion as JaxGaussian
from diffulab_tpu.networks.denoisers.unet import UNetModel as JaxUNet
from diffulab_tpu.training import optim as joptim
from diffulab_tpu_torch.config.instantiate import model_dtype_kwargs
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.diffuse.gaussian_diffusion import GaussianDiffusion
from diffulab_tpu_torch.networks.denoisers.unet import AttentionBlock, UNetModel
from diffulab_tpu_torch.ops.fused_mha import VALID_ROWS_HEAD_DIMS
from diffulab_tpu_torch.training import optim as toptim
from diffulab_tpu_torch.training.trainer import MultiStepOptimizer, train_step
from diffulab_tpu_torch.weights import state_dict_from_jax

#: head dim -> the toy UNet attending at it (one head at ds 2)
WIDTHS = {192: 96, 256: 128}
SHAPE = (2, 8, 8, 3)
FWD_TOL = 2e-2
LOSS_TOL = 2e-2
GRAD_TOL = 6e-2
LR = 1e-3
#: Adam's first update is lr·g/(|g| + eps): within 1% of lr·sign(g) where |g| > 1e-6, so 2e-5 apart at most
UPDATE_ATOL = 2.5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _kwargs(d):
    return dict(image_size=[8, 8], in_channels=3, model_channels=WIDTHS[d], out_channels=3, num_res_blocks=1,
                attention_resolutions=[2], channel_mult="1, 2", num_heads=1, resblock_updown=True,
                use_scale_shift_norm=True, n_classes=10, classifier_free=True)


def _pair(d, seed):
    """The JAX UNet at bf16 compute (parameters seeded noise) and its port twin built as the CLIs build
    a model under trainer.precision_type=bf16 (model_dtype_kwargs), the weights bridged."""
    jm = nnx.eval_shape(lambda: JaxUNet(**_kwargs(d), dtype=jnp.bfloat16, rngs=nnx.Rngs(0)))
    params = _randomize(jm, seed)
    tm = UNetModel(**_kwargs(d), **model_dtype_kwargs({"precision_type": "bf16"}), device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, tm), strict=True)
    return jm, tm


def _draws(seed):
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.standard_normal(SHAPE), -1, 1).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    return x0, noise, np.array([17, 802], np.int32), np.array([3, 8]), np.array([False, True])


@pytest.mark.parametrize("d", sorted(WIDTHS))
def test_bf16_unet_forward_matches_jax(d):
    jm, tm = _pair(d, 31)
    blocks = [m for m in tm.modules() if isinstance(m, AttentionBlock)]
    assert blocks and {m.dim_head for m in blocks} == {d} and d in VALID_ROWS_HEAD_DIMS
    assert all(p.dtype == torch.float32 for p in tm.parameters())  # fp32 masters
    x0, _, t, y, drop = _draws(32)
    ref = jm(jnp.asarray(x0), jnp.asarray(t), {"y": jnp.asarray(y)}, jnp.asarray(drop))["x"]
    seen = []
    hooks = [m.register_forward_pre_hook(lambda _, args: seen.append(args[0].dtype)) for m in blocks]
    with torch.no_grad():
        out = tm(torch.from_numpy(x0), torch.from_numpy(t), {"y": torch.from_numpy(y)}, torch.from_numpy(drop))["x"]
    for hook in hooks:
        hook.remove()
    assert seen == [torch.float32] * len(blocks)  # the residual stream stays fp32 into each attention block
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16 and out.shape == SHAPE
    ref = np.asarray(ref, np.float32)
    assert float(np.abs(out.float().numpy() - ref).max()) <= FWD_TOL * float(np.abs(ref).max())


def test_bf16_unet_train_step_matches_jax():
    d = 192
    jm, tm = _pair(d, 33)
    x0, noise, t, y, drop = _draws(34)
    kw = dict(lr=LR, weight_decay=1e-4)
    jd = JaxDiffuser(jm, "ddim", model_type="gaussian_diffusion", n_steps=1000)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def jax_loss(p):
        jd.denoiser = nnx.merge(graphdef, p, rest)
        return jd.compute_loss(jnp.asarray(x0), {"y": jnp.asarray(y)}, jnp.asarray(t), jnp.asarray(noise),
                               drop=jnp.asarray(drop))["loss"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    optimizer = joptim.adamw(**kw)
    updates, _ = optimizer.update(ref_grads, optimizer.init(params), params)
    flat = lambda tree: {"/".join(str(p) for p in path): np.asarray(v.get_value(), np.float32)  # noqa: E731
                         for path, v in tree.flat_state()}
    ref_params = state_dict_from_jax(flat(optax.apply_updates(params, updates)), tm)
    ref_grads = state_dict_from_jax(flat(ref_grads), tm)

    td = Diffuser(tm, "ddim", model_type="gaussian_diffusion", n_steps=1000)
    grads = {}
    for name, p in tm.named_parameters():
        p.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
    opt = MultiStepOptimizer(toptim.adamw(**kw)(list(tm.parameters())), 1)
    batch = {"model_inputs": {"x": torch.from_numpy(x0), "y": torch.from_numpy(y)}}
    losses = train_step(td, opt, None, batch, torch.from_numpy(t), torch.from_numpy(noise), torch.from_numpy(drop), 0)
    assert abs(float(losses["loss"]) - float(ref_loss)) <= LOSS_TOL * abs(float(ref_loss))
    settled = total = 0
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32, name
        g, r = grads[name].numpy(), ref_grads[name].numpy()
        if not np.any(r):  # the embedding rows of labels the batch does not use
            assert not np.any(g), name
            continue
        assert rel_err(g, r) < GRAD_TOL, name
        # elements whose gradient both sides know to 10% and well above Adam's eps: the same update there
        known = (np.abs(g - r) <= 0.1 * np.abs(r)) & (np.abs(r) > 1e-6)
        np.testing.assert_allclose(p.detach().numpy()[known], ref_params[name].numpy()[known], atol=UPDATE_ATOL,
                                   rtol=0, err_msg=name)
        settled, total = settled + known.sum(), total + known.size
    assert settled >= 0.8 * total, settled / total


@pytest.mark.parametrize("method", ["ddim", "ddpm"])
def test_gaussian_sampler_steps_on_a_bf16_prediction_match_jax(method):
    ours = GaussianDiffusion(sampling_method=method).set_steps(10).sampler
    ref = JaxGaussian(sampling_method=method).set_steps(10).sampler
    rng = np.random.default_rng(38)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    for t in (9, 0):
        pred = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32)).bfloat16()
        ts = np.full((SHAPE[0],), t, np.int32)
        key = jax.random.key(t)
        noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))
        r = ref.step(jnp.asarray(pred.float().numpy(), jnp.bfloat16), jnp.asarray(ts), jnp.asarray(x), rng=key,
                     clamp_x=t == 0)
        o = ours.step(pred, torch.from_numpy(ts).long(), torch.from_numpy(x), noise=torch.from_numpy(noise),
                      clamp_x=t == 0)
        assert set(o) == set(r)
        for name in r:
            assert o[name].dtype == torch.float32 and r[name].dtype == jnp.float32, name
            np.testing.assert_allclose(o[name].numpy(), np.asarray(r[name]), atol=1e-5, rtol=1e-5,
                                       err_msg=f"{name} at t={t}")
        x = np.array(r["x_prev"], np.float32)


def test_gaussian_loss_on_a_bf16_prediction_matches_jax():
    x0, noise, t, y, drop = _draws(39)
    w = np.random.default_rng(40).standard_normal(SHAPE).astype(np.float32)
    ours = GaussianDiffusion().compute_loss(
        lambda **kw: {"x": (kw["x"] * torch.from_numpy(w)).bfloat16()}, torch.from_numpy(x0),
        {"y": torch.from_numpy(y)}, torch.from_numpy(t), torch.from_numpy(noise), drop=torch.from_numpy(drop))
    ref = JaxGaussian().compute_loss(
        lambda **kw: {"x": (kw["x"] * jnp.asarray(w)).astype(jnp.bfloat16)}, jnp.asarray(x0), {"y": jnp.asarray(y)},
        jnp.asarray(t), jnp.asarray(noise), drop=jnp.asarray(drop))
    assert ours["loss"].dtype == torch.float32 and ref["loss"].dtype == jnp.float32
    assert abs(float(ours["loss"]) - float(ref["loss"])) <= 1e-5 * abs(float(ref["loss"]))
