"""The port's HF text embedders (networks/embedders/hf_text.py), the CLIs
they plug into, and fault F7, against the JAX package on the CPU.

- With one deterministic stub ``encode_fn`` in both packages: ``embed_host``
  and its cached null, the forward's null swap (the pooled embedding too),
  SD3's per-segment null fit at a boundary other than the null's, raw
  strings refused, and ``compute_on_dataset``'s columns, bit for bit.
- ``_default_encode`` of the three embedders through ``transformers`` on
  tiny models built from ``Qwen3VLConfig``, ``CLIPTextConfig``/``T5Config``
  and ``Idefics3Config`` with in-memory tokenizers (as
  tests/test_hf_embedders_torch.py builds them), against the JAX package's.
- ``precompute captions`` through both packages' CLIs on one tiny Qwen
  checkpoint, and ``sample --prompts`` at a toy size (a DDT of
  ``train_imagenet_repa_txt_to_img`` with that embedder and a tiny Flux2
  tower) against the library call it makes.
- F7: ``train_repa`` of both packages with ``trainer.lora_rank=4`` trains
  the whole model, the same losses as without it; the port's
  ``train_repa_txt_to_img`` too.
"""

import json
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffulab_tpu.data.streaming import ShardedDataset as JaxShardedDataset
from diffulab_tpu.networks.embedders import hf_text as jax_hf
from diffulab_tpu_torch.config import compose_config, instantiate
from diffulab_tpu_torch.config.instantiate import locate
from diffulab_tpu_torch.data.streaming import ShardedDataset, ShardedDatasetWriter
from diffulab_tpu_torch.diffuse import Diffuser
from diffulab_tpu_torch.examples import precompute, sample, train_repa
from diffulab_tpu_torch.networks.embedders import hf_text
from diffulab_tpu_torch.training.checkpoint import (
    restore_checkpoint,
    restore_sampling_model,
    save_checkpoint,
    split_state,
    train_modules,
    trainable_filter,
)
from diffulab_tpu_torch.training.losses import build_extra_losses

CONFIGS = sample.CONFIG_DIR
JAX_EXAMPLES = CONFIGS.parent / "examples"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)


def stub_encode(dim=16, seq=6, calls=None):
    """Deterministic embeddings from the texts' bytes; "" gives zeros."""
    def encode(texts):
        if calls is not None:
            calls.append(list(texts))
        seed = sum(sum(t.encode()) * (i + 1) for i, t in enumerate(texts))
        emb = np.random.default_rng(seed).normal(size=(len(texts), seq, dim)).astype(np.float32)
        mask = np.ones((len(texts), seq), bool)
        for i, t in enumerate(texts):
            if t == "":
                emb[i] = 0.0
                mask[i, 2:] = False
            else:
                mask[i, len(t) % seq + 1:] = False
        return {"embeddings": emb, "attn_mask": mask}
    return encode


def sd3_encode(texts):
    """SD3's layout: a CLIP segment then a T5 segment, the null's shorter than the batch's."""
    if list(texts) == [""]:
        clip_len, t5_len, fill = 2, 1, -1.0
    else:
        clip_len, t5_len, fill = 5, 3, 1.0
    b = len(texts)
    rng = np.random.default_rng(b)
    emb = np.concatenate([np.full((b, clip_len, 8), fill, np.float32),
                          2.0 * fill + rng.normal(size=(b, t5_len, 8)).astype(np.float32)], axis=1)
    return {"embeddings": emb, "attn_mask": np.ones((b, clip_len + t5_len), bool),
            "pooled_embeddings": np.full((b, 4), fill, np.float32) + np.arange(4, dtype=np.float32),
            "segment_boundaries": np.asarray([clip_len], np.int32)}


def _pair(name, encode, **kw):
    return (getattr(hf_text, name)(encode_fn=encode, device="cpu", **kw),
            getattr(jax_hf, name)(encode_fn=encode, **kw))


@pytest.mark.parametrize("name", ["QwenTextEmbedder", "SmolVLMTextEmbedder"])
def test_embed_host_and_its_cached_null(name):
    calls = []
    ours, ref = _pair(name, stub_encode(calls=calls), hidden_size=16)
    assert (ours.n_output, ours.output_size) == (ref.n_output, ref.output_size) == (1, (16,))
    texts = ["a red disk", "two blue rings"]
    a, b = ours.embed_host(texts), ref.embed_host(texts)
    assert sorted(a) == sorted(b) == ["attn_mask", "embeddings"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for k in ours._cache.null:
        np.testing.assert_array_equal(ours._cache.null[k], ref._cache.null[k])
    # the null ("") is encoded once per embedder, on the first call
    assert calls == [texts, [""], texts, [""]]
    ours.embed_host(["x"])
    assert calls[-1] == ["x"]
    assert ours.drop_conditions(texts, np.array([True, False])) == ["", texts[1]]


@pytest.mark.parametrize("pooled", [False, True])
def test_null_swap_matches_jax(pooled):
    """The CFG drop swaps in the cached null embedding and mask (tail-fitted to
    the batch's length), and the pooled null where there is one."""
    def encode(texts):
        out = stub_encode(seq=7 if texts == [""] else 5)(texts)
        if pooled:
            out["pooled_embeddings"] = np.stack([np.full(3, len(t), np.float32) for t in texts])
        return out

    ours, ref = _pair("QwenTextEmbedder", encode, hidden_size=16)
    out = ours.embed_host(["abc", "de", "fghij"])
    ref.embed_host(["abc", "de", "fghij"])
    drop = np.array([True, False, True])
    res = ours({k: torch.from_numpy(v) for k, v in out.items()}, drop=torch.from_numpy(drop))
    jres = ref({k: jnp.asarray(v) for k, v in out.items()}, drop=jnp.asarray(drop))
    assert sorted(res) == sorted(jres) == sorted(["embeddings", "attn_mask"] + (["pooled_embeddings"] if pooled else []))
    for k in res:
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]))
    np.testing.assert_array_equal(res["embeddings"][1].numpy(), out["embeddings"][1])
    assert not res["embeddings"][0].any() and res["attn_mask"][0].tolist() == [True, True, False, False, False]
    # without a drop the context passes through, with an all-ones mask where it has none
    plain = ours({"embeddings": torch.from_numpy(out["embeddings"])})
    assert torch.equal(plain["embeddings"], torch.from_numpy(out["embeddings"])) and bool(plain["attn_mask"].all())


def test_sd3_segment_fit_matches_jax():
    """SD3's [CLIP | T5] sequence: each null segment is fitted to the batch's
    segment on its own, at a boundary (5) other than the null's (2)."""
    ours, ref = _pair("SD3TextEmbedder", sd3_encode)
    assert (ours.n_output, ours.output_size) == (2, (2048, 4096))
    out = ours.embed_host(["a long caption", "another"])
    ref.embed_host(["a long caption", "another"])
    drop = np.array([True, False])
    res = ours({k: torch.from_numpy(v) for k, v in out.items()}, drop=torch.from_numpy(drop))
    jres = ref({k: jnp.asarray(v) for k, v in out.items()}, drop=jnp.asarray(drop))
    for k in ("embeddings", "attn_mask", "pooled_embeddings"):
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]))
    dropped = res["embeddings"][0].numpy()
    np.testing.assert_array_equal(dropped[:2], -1.0)
    np.testing.assert_array_equal(dropped[2:5], 0.0)
    np.testing.assert_array_equal(dropped[5:6], sd3_encode([""])["embeddings"][0, 2:3])
    np.testing.assert_array_equal(dropped[6:], 0.0)
    assert res["attn_mask"][0].tolist() == [True, True, False, False, False, True, False, False]
    np.testing.assert_array_equal(res["pooled_embeddings"][0].numpy(), sd3_encode([""])["pooled_embeddings"][0])


def test_raw_strings_raise_like_jax():
    ours, ref = _pair("QwenTextEmbedder", stub_encode(), hidden_size=16)
    ours.embed_host([""])
    ref.embed_host([""])
    with pytest.raises(TypeError, match="host-side"):
        ours(["raw text"])
    with pytest.raises(TypeError, match="host-side"):
        ref(["raw text"])
    with pytest.raises(RuntimeError, match="embed_host"):
        hf_text.QwenTextEmbedder(encode_fn=stub_encode(), device="cpu")(
            {"embeddings": torch.zeros(1, 6, 16)}, drop=torch.tensor([True]))


def _caption_shards(root, n=5):
    with ShardedDatasetWriter(root, shard_size=3) as writer:
        for i in range(n):
            writer.write({"caption": f"caption number {i} " * (i + 1), "label": np.int64(i)})


def test_compute_on_dataset_matches_jax(tmp_path):
    _caption_shards(tmp_path / "src")
    for name, encode, kw in (("QwenTextEmbedder", stub_encode(), {"hidden_size": 16}),
                             ("SD3TextEmbedder", sd3_encode, {})):
        ours, ref = _pair(name, encode, **kw)
        ours.compute_on_dataset(str(tmp_path / "src"), str(tmp_path / f"port_{name}"), batch_size=2, shard_size=2)
        ref.compute_on_dataset(str(tmp_path / "src"), str(tmp_path / f"jax_{name}"), batch_size=2, shard_size=2)
        a, b = ShardedDataset(tmp_path / f"port_{name}"), JaxShardedDataset(tmp_path / f"jax_{name}")
        assert len(a) == len(b) == 5 and sorted(a.columns) == sorted(b.columns)
        assert "caption_embeddings" in a.columns and "caption_mask" in a.columns
        assert ("caption_pooled" in a.columns) == (name == "SD3TextEmbedder")
        for i in range(5):
            for col in a.columns:
                np.testing.assert_array_equal(a[i][col], b[i][col])


# --- _default_encode through transformers, on tiny checkpoints ------------------------


def _word_tokenizer(words, specials, post_processor=True):
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    vocab = {w: i for i, w in enumerate(dict.fromkeys(words))}
    for tok in specials:
        vocab.setdefault(tok, len(vocab))
    tk = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    if post_processor:
        # as real CLIP/T5 tokenizers, BOS and EOS, so that "" (the CFG null) is not empty
        tk.post_processor = processors.TemplateProcessing(
            single="[BOS] $A [EOS]", special_tokens=[("[BOS]", vocab["[BOS]"]), ("[EOS]", vocab["[EOS]"])])
    return PreTrainedTokenizerFast(tokenizer_object=tk, unk_token="[UNK]", pad_token="[PAD]",
                                   model_input_names=["input_ids", "attention_mask"]), vocab


WORDS = ("a b c d e red blue circle square the image describe color shape size texture quantity text spatial "
         "relationships of objects and background system user assistant by detailing Describe :").split()
TEXTS = ["red circle", "blue square on the image background"]


def _qwen_dir(root):
    pytest.importorskip("transformers")
    from transformers import Qwen3VLConfig, Qwen3VLForConditionalGeneration

    fast, vocab = _word_tokenizer(WORDS, ("[UNK]", "[PAD]", "[BOS]", "[EOS]", "<|im_start|>", "<|im_end|>"))
    fast.save_pretrained(root)
    torch.manual_seed(0)
    cfg = Qwen3VLConfig(
        text_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
                         intermediate_size=64, vocab_size=len(vocab) + 10, max_position_embeddings=512,
                         rope_scaling={"rope_type": "default", "mrope_section": [2, 3, 3], "mrope_interleaved": True}),
        vision_config=dict(depth=2, hidden_size=32, intermediate_size=64, num_heads=2, out_hidden_size=32,
                           patch_size=4, spatial_merge_size=1, temporal_patch_size=1))
    Qwen3VLForConditionalGeneration(cfg).save_pretrained(root)
    return root


@pytest.fixture(scope="module")
def qwen_dir(tmp_path_factory):
    return _qwen_dir(tmp_path_factory.mktemp("qwen"))


def _sd3_dirs(root):
    pytest.importorskip("transformers")
    from transformers import CLIPTextConfig, CLIPTextModel, CLIPTextModelWithProjection, T5Config, T5EncoderModel

    fast, vocab = _word_tokenizer(WORDS, ("[UNK]", "[PAD]", "[BOS]", "[EOS]"))
    dirs = {name: root / name for name in ("clip_l", "clip_g", "t5")}
    for d in dirs.values():
        fast.save_pretrained(d)
    torch.manual_seed(1)
    clip_kw = dict(vocab_size=len(vocab) + 10, max_position_embeddings=128, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=32)
    CLIPTextModel(CLIPTextConfig(hidden_size=16, **clip_kw)).save_pretrained(dirs["clip_l"])
    CLIPTextModelWithProjection(CLIPTextConfig(hidden_size=16, projection_dim=16, **clip_kw)).save_pretrained(
        dirs["clip_g"])
    T5EncoderModel(T5Config(vocab_size=len(vocab) + 10, d_model=4096, d_kv=8, d_ff=32, num_layers=1,
                            num_heads=2)).save_pretrained(dirs["t5"])
    return {"clip_l_path": str(dirs["clip_l"]), "clip_g_path": str(dirs["clip_g"]), "t5_path": str(dirs["t5"])}


def _smolvlm_dir(root, monkeypatch):
    pytest.importorskip("transformers")
    import transformers.processing_utils as pu

    # Idefics3Processor's strict component class check relaxed (the real SmolVLM
    # tokenizer is GPT2-style; this one is a tiny offline WordLevel one)
    monkeypatch.setattr(pu.ProcessorMixin, "check_argument_for_proper_class", lambda self, name, arg: type(arg))
    from transformers import Idefics3Config, Idefics3ForConditionalGeneration
    from transformers.models.idefics3.image_processing_idefics3 import Idefics3ImageProcessor
    from transformers.models.idefics3.processing_idefics3 import Idefics3Processor

    specials = ["<|im_start|>", "<end_of_utterance>", "<image>", "<fake_token_around_image>", "<global-img>"]
    fast, vocab = _word_tokenizer("red blue circle square the image Describe User Assistant :".split(),
                                  ["[UNK]", "[PAD]", *specials], post_processor=False)
    fast.add_special_tokens({"additional_special_tokens": specials})
    cfg = Idefics3Config(
        text_config=dict(hidden_size=24, num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
                         intermediate_size=48, vocab_size=len(vocab) + 10, max_position_embeddings=512),
        vision_config=dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
                           image_size=32, patch_size=8),
        image_token_id=vocab["<image>"], scale_factor=1)
    torch.manual_seed(2)
    Idefics3ForConditionalGeneration(cfg).save_pretrained(root)
    Idefics3Processor(image_processor=Idefics3ImageProcessor(do_image_splitting=False, size={"longest_edge": 32}),
                      tokenizer=fast).save_pretrained(root)
    return root


@pytest.mark.parametrize("name", ["QwenTextEmbedder", "SD3TextEmbedder", "SmolVLMTextEmbedder"])
def test_default_encode_matches_jax(name, qwen_dir, tmp_path, monkeypatch):
    """The real transformers path of each embedder (template strip, masks,
    CLIP/T5 concat, pooled, segment boundaries), the port's on its device
    (the CPU here) against the JAX package's, and the null swap over the real
    null embedding."""
    if name == "QwenTextEmbedder":
        kw = dict(model_path=str(qwen_dir), max_length=64, hidden_size=32, template_start_idx=5)
    elif name == "SD3TextEmbedder":
        kw = _sd3_dirs(tmp_path)
    else:
        kw = dict(model_path=str(_smolvlm_dir(tmp_path / "smolvlm", monkeypatch)), max_length=32, hidden_size=24,
                  template_start_idx=4)
    ours = getattr(hf_text, name)(device="cpu", **kw)
    ref = getattr(jax_hf, name)(**kw)
    texts = TEXTS if name != "SmolVLMTextEmbedder" else ["red circle", "blue square the image"]
    a, b = ours.embed_host(texts), ref.embed_host(texts)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    assert a["attn_mask"][0].sum() < a["attn_mask"][1].sum()
    np.testing.assert_array_equal(np.asarray(ours._cache.last_boundaries), np.asarray(ref._cache.last_boundaries))
    drop = np.array([True, False])
    res = ours({k: torch.from_numpy(v) for k, v in a.items()}, drop=torch.from_numpy(drop))
    jres = ref({k: jnp.asarray(v) for k, v in a.items()}, drop=jnp.asarray(drop))
    for k in res:
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]))


def test_default_encode_without_transformers_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        hf_text.QwenTextEmbedder(model_path="no_such_dir", device="cpu").embed_host(["a"])


# --- the CLIs -----------------------------------------------------------------------------


def _qwen_config(root, qwen_dir):
    """A configs/embedder/ group naming the tiny Qwen checkpoint."""
    path = root / "tiny_qwen.yaml"
    path.write_text(json.dumps({"_target_": "diffulab_tpu.networks.embedders.hf_text.QwenTextEmbedder",
                                "model_path": str(qwen_dir), "max_length": 64, "hidden_size": 32,
                                "template_start_idx": 5}))
    return path


def test_qwen_config_target_resolves():
    assert locate("diffulab_tpu.networks.embedders.hf_text.QwenTextEmbedder") is hf_text.QwenTextEmbedder
    emb = instantiate(compose_config(CONFIGS, "train_imagenet_repa_txt_to_img")["embedder"], device="cpu")
    assert isinstance(emb, hf_text.QwenTextEmbedder) and emb.model_id == "Qwen/Qwen3-VL-2B-Instruct"
    assert (emb.max_length, emb.output_size) == (1024, (2048,))


def test_precompute_captions_matches_jax(qwen_dir, tmp_path, monkeypatch):
    """Both packages' CLIs, one argv: the embedder group given as a path to a
    group file (the CLIs join it onto configs/embedder/, and an absolute path
    replaces that)."""
    _caption_shards(tmp_path / "src")
    group = str(_qwen_config(tmp_path, qwen_dir)).removesuffix(".yaml")
    args = ["captions", "--embedder", group, "--src", str(tmp_path / "src"), "--batch-size", "2"]
    precompute.main([*args, "--dst", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["precompute.py", *args, "--dst", str(tmp_path / "jax")])
    runpy.run_path(str(JAX_EXAMPLES / "precompute.py"), run_name="__main__")
    a, b = ShardedDataset(tmp_path / "port"), JaxShardedDataset(tmp_path / "jax")
    assert len(a) == len(b) == 5
    assert sorted(a.columns) == sorted(b.columns) == ["caption", "caption_embeddings", "caption_mask", "label"]
    for i in range(5):
        assert a[i]["caption_embeddings"].shape[-1] == 32
        for col in a.columns:
            np.testing.assert_array_equal(a[i][col], b[i][col])


#: train_imagenet_repa_txt_to_img at a toy size: its DDT 64 wide (4 heads of 16, 1 + 1 blocks), a 2-level Flux2
#: tower of 16/32 channels (4 latent channels, 16 packed), the tiny Qwen checkpoint's 32-wide states
TXT_TOY = ["model.inner_dim=64", "model.num_heads=4", "model.encoder_depth=1", "model.decoder_depth=1",
           "model.rope_axes_dim=[4,6,6]", "model.input_channels=16", "model.output_channels=16",
           "vision_tower.base_channels=16", "vision_tower.ch_mult=[1,2]", "vision_tower.num_res_blocks=1",
           "vision_tower.latent_channels=4", "embedder.max_length=64", "embedder.hidden_size=32",
           "embedder.template_start_idx=5"]


def test_sample_prompts_end_to_end(qwen_dir, tmp_path):
    """``sample --prompts`` on an ``ema`` entry of the toy txt2img model: the
    prompts tiled to --n, embedded on the host by the Qwen embedder (its
    context equal to the JAX embedder's), and the grid's images those of the
    library call with that context and the same seed."""
    overrides = [*TXT_TOY, f"embedder.model_path={qwen_dir}"]
    cfg = compose_config(CONFIGS, "train_imagenet_repa_txt_to_img", overrides)
    torch.manual_seed(0)
    embedder = instantiate(cfg["embedder"], device="cpu")
    model = instantiate(cfg["model"], context_embedder=embedder, device="cpu")
    # the config's REPA loss rides in the checkpoint beside the denoiser, as a run's does
    modules = train_modules(model, build_extra_losses(cfg, seed=4, device="cpu"))
    params, _ = split_state(modules, trainable_filter(model))
    save_checkpoint(tmp_path / "ema", {"params": {k: v + 0.01 * torch.randn(v.shape) for k, v in params.items()}})
    argv = ["--device", "cpu", "--config-name", "train_imagenet_repa_txt_to_img", "--ckpt", str(tmp_path / "ema"),
            "--n", "3", "--steps", "2", "--guidance", "1.5", "--image-size", "16", "--seed", "4",
            "--prompts", "red circle|blue square on the image", "--out", str(tmp_path / "grid.png"), *overrides]
    result = sample.main(argv)
    assert result["images"].shape == (3, 16, 16, 3) and (tmp_path / "grid.png").exists()

    texts = ["red circle", "blue square on the image", "red circle"]
    ref_emb = jax_hf.QwenTextEmbedder(model_path=str(qwen_dir), max_length=64, hidden_size=32, template_start_idx=5)
    context = ref_emb.embed_host(texts)
    torch.manual_seed(4)  # the CLI's construction order under its --seed: embedder, denoiser, tower
    live = instantiate(cfg["model"], context_embedder=instantiate(cfg["embedder"], device="cpu"), device="cpu")
    tower = instantiate(cfg["vision_tower"], device="cpu")
    restore_sampling_model(tmp_path / "ema", live, build_extra_losses(cfg, seed=4, device="cpu"), cfg["trainer"])
    live.context_embedder.embed_host(texts)  # the null cache, as the CLI's first call fills it
    diffuser = Diffuser(live.eval(), "euler", n_steps=cfg["diffuser"]["n_steps"], vision_tower=tower,
                        extra_args=cfg["diffuser"]["extra_args"])
    diffuser.set_steps(2)
    out = diffuser.generate({"context": {k: torch.from_numpy(v) for k, v in context.items()}},
                            data_shape=(3, 4, 4, 16), generator=torch.Generator().manual_seed(4),
                            guidance_scale=1.5, clamp_x=True, device="cpu")["x"]
    np.testing.assert_array_equal(result["images"], np.clip(out.numpy() * 0.5 + 0.5, 0, 1))


# --- F7: the REPA CLIs train the whole model under trainer.lora_rank -----------------------


def _loss_rows(run):
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if "loss" in k.lower()} for r in rows if any("loss" in k.lower() for k in r)]


def test_f7_train_repa_trains_the_whole_model_under_lora_rank(tmp_path, monkeypatch):
    """train_repa in both packages, with and without ``trainer.lora_rank=4``:
    the same loss rows, and the checkpoint's trainable ``params`` the whole
    model's in both (no adapters, the same count, the port's equal to the
    JAX package's)."""
    from test_torch_port_config import PRECOMPUTED_OVERRIDES, _write_latent_shards

    from diffulab_tpu.training.checkpoint import restore_checkpoint as jax_restore

    _write_latent_shards(tmp_path / "imagenet")
    data = [f"dataset.{s}.data_path={tmp_path / 'imagenet'}" for s in ("train", "val")]
    counts, rows = {}, {}
    for lora in ([], ["trainer.lora_rank=4"]):
        save = tmp_path / f"port{len(lora)}"
        (trainer,) = train_repa.main(["--device", "cpu", *PRECOMPUTED_OVERRIDES, *data, *lora,
                                      f"trainer.save_path={save}"])
        run = save / "imagenet_repa_flow_matching"
        params = restore_checkpoint(run / "checkpoints" / "denoiser")["params"]
        assert not any("lora" in k for k in params) and trainer.step > 0
        counts["port", len(lora)] = sum(v.numel() for v in params.values())
        rows["port", len(lora)] = _loss_rows(run)

        save = tmp_path / f"jax{len(lora)}"
        monkeypatch.setattr(sys, "argv", ["train_repa.py", *PRECOMPUTED_OVERRIDES, *data, *lora,
                                          f"trainer.save_path={save}", "trainer.async_checkpointing=false"])
        runpy.run_path(str(JAX_EXAMPLES / "train_repa.py"), run_name="__main__")
        run = save / "imagenet_repa_flow_matching"
        params = jax_restore(run / "checkpoints" / "denoiser")["params"]
        counts["jax", len(lora)] = sum(int(np.size(v)) for v in jax.tree.leaves(params))
        rows["jax", len(lora)] = _loss_rows(run)
    for pkg in ("port", "jax"):
        assert rows[pkg, 0] == rows[pkg, 1] and rows[pkg, 0]
        assert all(np.isfinite(v) for r in rows[pkg, 0] for v in r.values())
    assert len({counts[k] for k in counts}) == 1, counts


def test_f7_train_repa_txt_to_img_trains_the_whole_model_under_lora_rank(tmp_path, monkeypatch):
    """The port's train_repa_txt_to_img on the toy hard benchmark with
    ``trainer.lora_rank=4``: every denoiser parameter in the trainable split
    and trained, the same losses as without it."""
    from test_torch_port_h1_cli import BUILD, HARD, RUN, TOY

    from diffulab_tpu_torch.examples import train_repa_txt_to_img
    from diffulab_tpu_torch.scripts import build_hard_txt2img

    monkeypatch.chdir(tmp_path)
    build_hard_txt2img.main(BUILD + ["--out", "data/hard_txt2img"])
    name = HARD[0]
    out = {}
    for lora in ([], ["trainer.lora_rank=4"]):
        (trainer,) = train_repa_txt_to_img.main(["--device", "cpu", "--config-name", name, *TOY[name], *RUN, *lora,
                                                 f"trainer.project_name=f7_{len(lora)}"])
        run = tmp_path / "runs" / f"f7_{len(lora)}"
        params = restore_checkpoint(run / "checkpoints" / "denoiser")["params"]
        out[len(lora)] = (_loss_rows(run), sorted(params), trainer.step)
    assert out[0] == out[1] and out[0][2] > 0
    cfg = compose_config(CONFIGS, name, TOY[name])
    model = instantiate(cfg["model"], context_embedder=instantiate(cfg["embedder"], device="cpu"), device="cpu")
    assert out[1][1] == sorted(n for n, _ in model.named_parameters() if not n.startswith("context_embedder."))
