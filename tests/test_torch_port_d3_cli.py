"""A bf16 UNet through the port's CLIs on the CPU: ``train_diffusion`` on
``configs/train_synthetic_ddpm.yaml`` with the user's override
``trainer.precision_type=bf16`` (compute in bf16, fp32 master parameters,
AdamW on the masters, post-hoc EMA), cut to a toy width that still attends
at head dim 192 (``model_channels`` 96, ``channel_mult`` 1, 2, one head at
ds 2 on 8x8 images: 16 tokens) and to two steps, then ``sample`` from its
checkpoint with ``model.dtype=bfloat16`` (the sample CLI builds the model
from the config without the trainer's precision, as the reference's does).
Every attention call of both runs goes through the fused route's K1 (and
under training K2) in bf16 at D = 192: on the CPU their plain versions,
which no longer refuse bf16 at that dim.
"""

import json
import sys

import numpy as np
import pytest
import torch

import diffulab_tpu_torch.ops.attention as attention
from diffulab_tpu_torch.examples import sample, train_diffusion
from diffulab_tpu_torch.training.checkpoint import restore_checkpoint

CONFIG = "train_synthetic_ddpm"
MODEL = ["model.model_channels=96", "model.channel_mult=1, 2", "model.attention_resolutions=[2]",
         "model.num_heads=1", "model.num_res_blocks=1", "model.image_size=[8, 8]", "dataset.train.image_size=8",
         "dataset.val.image_size=8"]
RUN = ["dataset.train.n_samples=32", "dataset.val.n_samples=16", "dataloader.batch_size=16", "trainer.n_epoch=1",
       "trainer.val_steps=2", "trainer.posthoc_ema=true", "trainer.precision_type=bf16"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)


@pytest.fixture
def fused_calls(monkeypatch):
    """(dtype, head dim, whether it builds a backward) of every fused-route attention call."""
    calls = []
    inner = attention.fused_mha

    def recording(q, k, v, *args, **kwargs):
        calls.append((q.dtype, q.shape[-1], torch.is_grad_enabled() and q.requires_grad))
        return inner(q, k, v, *args, **kwargs)

    monkeypatch.setattr(attention, "fused_mha", recording)
    return calls


def test_bf16_unet_trains_and_samples_through_the_clis(tmp_path, fused_calls):
    (trainer,) = train_diffusion.main(["--device", "cpu", "--config-name", CONFIG, *MODEL, *RUN,
                                       f"trainer.save_path={tmp_path}"])
    run = tmp_path / "synthetic_ddpm"
    assert trainer.step == 2 and trainer.precision_type == "bf16"
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r[key] for r in rows for key in ("train/loss", "val/loss") if key in r]
    assert len(losses) == 2 and all(np.isfinite(losses))  # the epoch's train and validation losses
    # 4 attention blocks a model call (one at ds 2 in the encoder, the middle's, two at ds 2 in the decoder);
    # 2 train steps with their backward, then the validation loss and images without one
    assert {(dtype, d) for dtype, d, _ in fused_calls} == {(torch.bfloat16, 192)}
    assert sum(grad for *_, grad in fused_calls) == 2 * 4
    params = restore_checkpoint(run / "checkpoints" / "denoiser")["params"]
    assert params and all(p.dtype == torch.float32 for p in params.values())  # fp32 masters
    assert len(sorted((run / "checkpoints" / "phema").glob("step*_g*"))) == 2

    fused_calls.clear()
    result = sample.main(["--device", "cpu", "--config-name", CONFIG, "--ckpt", str(run / "checkpoints" / "ema"),
                          "--n", "4", "--guidance", "1.5", "--labels", "0,1", "--steps", "2", "--out",
                          str(tmp_path / "grid.png"), *MODEL, "model.dtype=bfloat16"])
    images = result["images"]
    assert images.shape == (4, 8, 8, 3) and np.isfinite(images).all() and (images >= 0).all() and (images <= 1).all()
    assert fused_calls == [(torch.bfloat16, 192, False)] * (2 * 4)  # 2 steps of one CFG-batched model call
