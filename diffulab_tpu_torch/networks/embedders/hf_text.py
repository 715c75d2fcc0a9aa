"""Frozen HF text embedders: Qwen3-VL, the SD3 triple encoder, SmolVLM (port of
diffulab_tpu/networks/embedders/hf_text.py; reference
src/diffulab/networks/embedders/{qwen.py:11-87, sd3.py:15-216, smolVLM.py:14-91}).

The split of the JAX package, kept: the frozen language model runs on the
host side (``embed_host``), outside the denoiser's forward, either offline
(``compute_on_dataset`` writes ``caption_embeddings``/``caption_mask``
columns) or in the trainer's host loop before the batch goes to the card.
The forward only applies the CFG condition drop by swapping in the cached
null ("" prompt) embedding with ``torch.where``, the mechanism of
:class:`~diffulab_tpu_torch.networks.embedders.PrecomputedEmbedder`,
mirroring the reference's drop to the empty string (qwen.py:36-46).

The models load lazily from local checkpoints (``model_path``) through
``transformers``, imported only when ``_default_encode`` first runs; they
run on the embedder's ``device`` and the results come back as numpy, the
``EncodeFn`` contract. Without ``transformers`` that call raises
``ImportError``. An ``encode_fn`` may be injected instead (tests, custom
encoders).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from diffulab_tpu_torch.data.streaming import ShardedDataset, ShardedDatasetWriter
from diffulab_tpu_torch.networks.embedders.common import ContextEmbedder, ContextEmbedderOutput
from diffulab_tpu_torch.utils import resolve_device

# texts -> {"embeddings": [B, L, D], "attn_mask": [B, L] (optional),
#           "pooled_embeddings": [B, Dp] (optional)} as numpy
EncodeFn = Callable[[Sequence[str]], dict[str, np.ndarray]]


class _HostCache:
    """Host-side numpy constants: the null embedding, and the segment layouts
    (boundary indices where each trailing segment starts, e.g. SD3's CLIP|T5
    sequence concat) of the null and of the most recently encoded batch."""

    def __init__(self) -> None:
        self.null: dict[str, np.ndarray] | None = None
        self.null_boundaries: np.ndarray | None = None
        self.last_boundaries: np.ndarray | None = None


class HFTextEmbedder(ContextEmbedder):
    """Base: host-side encode and the null swap of the CFG drop in the forward."""

    def __init__(self, encode_fn: EncodeFn | None = None, device: str | torch.device | None = None) -> None:
        super().__init__()
        self._encode_fn = encode_fn
        self._cache = _HostCache()
        self.device = resolve_device(device)

    # --- host side ----------------------------------------------------------
    def _default_encode(self, texts: Sequence[str]) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def embed_host(self, texts: Sequence[str]) -> dict[str, np.ndarray]:
        encode = self._encode_fn or self._default_encode
        out = dict(encode(list(texts)))
        # the segment layout (where the encoder concatenates sub-encoder sequences)
        # stays on the host: it shapes the null swap, it is not batch data
        self._cache.last_boundaries = out.pop("segment_boundaries", None)
        if self._cache.null is None:
            null_out = dict(encode([""]))
            self._cache.null_boundaries = null_out.pop("segment_boundaries", None)
            self._cache.null = {k: np.asarray(v[0]) for k, v in null_out.items()}
        return out

    def drop_conditions(self, context: Sequence[str], drop: np.ndarray) -> list[str]:
        """Host-side string drop (reference qwen.py:36-46)."""
        return ["" if d else c for c, d in zip(context, drop)]

    def compute_on_dataset(self, dataset_path: str, dst_path: str, caption_key: str = "caption",
                           batch_size: int = 32, shard_size: int = 1024) -> None:
        """Offline caption embedding: adds the caption_embeddings and
        caption_mask (and caption_pooled) columns that ImageNetmultiAR reads."""
        dataset = ShardedDataset(dataset_path)
        with ShardedDatasetWriter(dst_path, shard_size=shard_size) as writer:
            n = len(dataset)
            for start in range(0, n, batch_size):
                samples = [dataset[i] for i in range(start, min(start + batch_size, n))]
                out = self.embed_host([str(s[caption_key]) for s in samples])
                for i, s in enumerate(samples):
                    row = {**s, "caption_embeddings": out["embeddings"][i].astype(np.float32)}
                    if "attn_mask" in out:
                        row["caption_mask"] = out["attn_mask"][i].astype(bool)
                    if "pooled_embeddings" in out:
                        row["caption_pooled"] = out["pooled_embeddings"][i].astype(np.float32)
                    writer.write(row)

    # --- the forward --------------------------------------------------------
    def _null(self, key: str) -> np.ndarray:
        if self._cache.null is None:
            raise RuntimeError("null embedding not cached: call embed_host (host side) once before the forward")
        return self._cache.null[key]

    @staticmethod
    def _fit_segment(emb: np.ndarray, mask: np.ndarray, target: int) -> tuple[np.ndarray, np.ndarray]:
        """Tail-pad or truncate one segment to ``target`` tokens (host numpy)."""
        if emb.shape[0] < target:
            pad = target - emb.shape[0]
            emb = np.pad(emb, ((0, pad), (0, 0)))
            mask = np.pad(mask, (0, pad))
        return emb[:target], mask[:target]

    def _fit_null(self, seq: int) -> tuple[np.ndarray, np.ndarray]:
        """The cached "" embedding fitted to the batch's sequence length.

        Where the encoder records ``segment_boundaries`` (SD3's CLIP|T5
        sequence concat; reference sd3.py:187-216 handles nulls per encoder),
        each null segment is fitted to the batch's segment, so that the
        boundary stays aligned; otherwise the whole sequence is tail-fitted.
        """
        null_emb = np.asarray(self._null("embeddings"), np.float32)
        null_mask = np.asarray(self._cache.null.get("attn_mask", np.ones((null_emb.shape[0],), bool))).astype(bool)
        nb = self._cache.null_boundaries
        bb = self._cache.last_boundaries
        if nb is not None and bb is not None and len(nb) == len(bb):
            n_starts = [0, *np.asarray(nb, int).tolist(), null_emb.shape[0]]
            b_starts = [0, *np.asarray(bb, int).tolist(), seq]
            embs, masks = [], []
            for i in range(len(n_starts) - 1):
                e, m = self._fit_segment(null_emb[n_starts[i]:n_starts[i + 1]], null_mask[n_starts[i]:n_starts[i + 1]],
                                         b_starts[i + 1] - b_starts[i])
                embs.append(e)
                masks.append(m)
            return np.concatenate(embs, 0), np.concatenate(masks, 0)
        return self._fit_segment(null_emb, null_mask, seq)

    def forward(self, context: Any, drop: torch.Tensor | None = None) -> ContextEmbedderOutput:
        if isinstance(context, (list, tuple)):
            raise TypeError("raw strings do not enter the forward: embed them host-side with embed_host (the "
                            "trainer does this itself) or precompute them with compute_on_dataset")
        emb = torch.as_tensor(context["embeddings"])
        batch, seq = emb.shape[:2]
        out: ContextEmbedderOutput = {"embeddings": emb}
        attn_mask = context.get("attn_mask")
        if attn_mask is None:
            attn_mask = torch.ones((batch, seq), dtype=torch.bool, device=emb.device)
        attn_mask = torch.as_tensor(attn_mask, device=emb.device)

        if drop is not None:
            null_emb, null_mask = self._fit_null(seq)
            null_emb = torch.as_tensor(null_emb, device=emb.device).to(emb.dtype)
            null_mask = torch.as_tensor(null_mask, device=emb.device)
            out["embeddings"] = torch.where(drop[:, None, None], null_emb[None], emb)
            attn_mask = torch.where(drop[:, None], null_mask[None], attn_mask)

        out["attn_mask"] = attn_mask
        if "pooled_embeddings" in context:
            pooled = torch.as_tensor(context["pooled_embeddings"], device=emb.device)
            if drop is not None and "pooled_embeddings" in (self._cache.null or {}):
                null_pooled = torch.as_tensor(self._null("pooled_embeddings"), device=emb.device).to(pooled.dtype)
                pooled = torch.where(drop[:, None], null_pooled[None], pooled)
            out["pooled_embeddings"] = pooled
        return out


class QwenTextEmbedder(HFTextEmbedder):
    """Frozen Qwen3-VL LM encoder (reference qwen.py:11-87): a fixed
    system-prompt template, its first ``template_start_idx`` (34) tokens stripped."""

    PROMPT_TEMPLATE = (
        "<|im_start|>system\nDescribe the image by detailing the color, shape, size, texture, "
        "quantity, text, spatial relationships of the objects and background:<|im_end|>\n"
        "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n"
    )

    def __init__(self, model_id: str = "Qwen/Qwen3-VL-2B-Instruct", max_length: int = 1024,
                 hidden_size: int = 2048, template_start_idx: int = 34,
                 encode_fn: EncodeFn | None = None, model_path: str | None = None,
                 device: str | torch.device | None = None, **_: Any) -> None:
        super().__init__(encode_fn, device)
        self.model_id = model_path or model_id
        self.max_length = max_length
        self.template_start_idx = template_start_idx
        self._output_size = (hidden_size,)
        self._n_output = 1
        self._model = None

    def _load(self):
        if self._model is not None:
            return
        from transformers import AutoTokenizer, Qwen3VLForConditionalGeneration  # noqa: PLC0415

        self._model = Qwen3VLForConditionalGeneration.from_pretrained(self.model_id, dtype="auto").eval()
        self._model.to(self.device)
        self._tokenizer = AutoTokenizer.from_pretrained(self.model_id)
        self._output_size = (self._model.config.text_config.hidden_size,)

    def _default_encode(self, texts: Sequence[str]) -> dict[str, np.ndarray]:
        self._load()
        prompts = [self.PROMPT_TEMPLATE.format(t) for t in texts]
        tokens = self._tokenizer(prompts, max_length=self.max_length + self.template_start_idx,
                                 padding=True, truncation=True, return_tensors="pt").to(self.device)
        with torch.inference_mode():
            hidden = self._model(input_ids=tokens.input_ids, attention_mask=tokens.attention_mask,
                                 output_hidden_states=True).hidden_states[-1]
        s = self.template_start_idx
        return {
            "embeddings": hidden[:, s:].float().cpu().numpy(),
            "attn_mask": tokens.attention_mask[:, s:].bool().cpu().numpy(),
        }


class SmolVLMTextEmbedder(HFTextEmbedder):
    """Frozen SmolVLM-256M (Idefics3) encoder (reference smolVLM.py:14-91)."""

    PROMPT_TEMPLATE = "<|im_start|>User: Describe the image: {}<end_of_utterance>\nAssistant:"

    def __init__(self, model_id: str = "HuggingFaceTB/SmolVLM-256M-Instruct",
                 max_length: int = 1024, hidden_size: int = 576, template_start_idx: int = 33,
                 encode_fn: EncodeFn | None = None, model_path: str | None = None,
                 device: str | torch.device | None = None, **_: Any) -> None:
        super().__init__(encode_fn, device)
        self.model_id = model_path or model_id
        self.max_length = max_length
        self.template_start_idx = template_start_idx
        self._output_size = (hidden_size,)
        self._n_output = 1
        self._model = None

    def _load(self):
        if self._model is not None:
            return
        from transformers import AutoModelForVision2Seq, AutoProcessor  # noqa: PLC0415

        self._model = AutoModelForVision2Seq.from_pretrained(self.model_id, dtype="auto").eval()
        self._model.to(self.device)
        self._processor = AutoProcessor.from_pretrained(self.model_id)

    def _default_encode(self, texts: Sequence[str]) -> dict[str, np.ndarray]:
        self._load()
        prompts = [self.PROMPT_TEMPLATE.format(t) for t in texts]
        tokens = self._processor.tokenizer(prompts, max_length=self.max_length + self.template_start_idx,
                                           padding=True, truncation=True, return_tensors="pt").to(self.device)
        with torch.inference_mode():
            hidden = self._model.model.text_model(input_ids=tokens.input_ids,
                                                  attention_mask=tokens.attention_mask).last_hidden_state
        s = self.template_start_idx
        return {
            "embeddings": hidden[:, s:].float().cpu().numpy(),
            "attn_mask": tokens.attention_mask[:, s:].bool().cpu().numpy(),
        }


class SD3TextEmbedder(HFTextEmbedder):
    """The SD3 triple encoder (reference sd3.py:15-216): CLIP-L/14, CLIP-bigG/14
    and T5. pooled = the concat of the CLIP pooled outputs [B, 2048]; sequence
    = the CLIP token states channel-concatenated, zero-padded to 4096, then
    sequence-concatenated with the T5 states. ``n_output == 2``."""

    def __init__(self, clip_l_path: str = "openai/clip-vit-large-patch14",
                 clip_g_path: str = "laion/CLIP-ViT-bigG-14-laion2B-39B-b160k",
                 t5_path: str = "google/t5-v1_1-xxl",
                 encode_fn: EncodeFn | None = None, device: str | torch.device | None = None, **_: Any) -> None:
        super().__init__(encode_fn, device)
        self.clip_l_path = clip_l_path
        self.clip_g_path = clip_g_path
        self.t5_path = t5_path
        self._output_size = (2048, 4096)  # (pooled, sequence)
        self._n_output = 2
        self._models = None

    def _load(self):
        if self._models is not None:
            return
        from transformers import (  # noqa: PLC0415
            AutoTokenizer,
            CLIPTextModel,
            CLIPTextModelWithProjection,
            T5EncoderModel,
        )

        self._models = {
            "clip_l": CLIPTextModel.from_pretrained(self.clip_l_path).eval().to(self.device),
            "tok_l": AutoTokenizer.from_pretrained(self.clip_l_path),
            "clip_g": CLIPTextModelWithProjection.from_pretrained(self.clip_g_path).eval().to(self.device),
            "tok_g": AutoTokenizer.from_pretrained(self.clip_g_path),
            "t5": T5EncoderModel.from_pretrained(self.t5_path).eval().to(self.device),
            "tok_t5": self._load_t5_tokenizer(),
        }

    def _load_t5_tokenizer(self):
        # the slow sentencepiece class honours legacy=False exactly (the reference's);
        # AutoTokenizer may load a prebuilt tokenizer.json that predates the legacy fix.
        # It serves where sentencepiece is missing, and for local checkpoints that ship a
        # generic fast tokenizer
        from transformers import AutoTokenizer, T5Tokenizer  # noqa: PLC0415

        try:
            return T5Tokenizer.from_pretrained(self.t5_path, legacy=False)
        except (ImportError, ValueError, OSError):
            return AutoTokenizer.from_pretrained(self.t5_path, legacy=False)

    def _default_encode(self, texts: Sequence[str]) -> dict[str, np.ndarray]:
        self._load()
        m = self._models
        with torch.inference_mode():
            tl = m["tok_l"](list(texts), return_tensors="pt", padding=True).to(self.device)
            ol = m["clip_l"](**tl)
            tg = m["tok_g"](list(texts), return_tensors="pt", padding=True).to(self.device)
            og = m["clip_g"](**tg)
            tt = m["tok_t5"](list(texts), return_tensors="pt", padding=True).to(self.device)
            ot = m["t5"](**tt)

            pooled = torch.cat([ol.pooler_output, og.text_embeds], dim=-1)  # [B, 2048]
            # the CLIP states channel-concatenated, zero-padded to 4096
            seq_len = max(ol.last_hidden_state.shape[1], og.last_hidden_state.shape[1])

            def pad_seq(x, target):
                return torch.nn.functional.pad(x, (0, 0, 0, target - x.shape[1]))

            clip_cat = torch.cat([pad_seq(ol.last_hidden_state, seq_len), pad_seq(og.last_hidden_state, seq_len)],
                                 dim=-1)
            clip_cat = torch.nn.functional.pad(clip_cat, (0, 4096 - clip_cat.shape[-1]))
            seq = torch.cat([clip_cat, ot.last_hidden_state], dim=1)  # [B, Nc + Nt5, 4096]
            mask_clip = torch.nn.functional.pad(tl.attention_mask.bool(), (0, seq_len - tl.attention_mask.shape[1]))
            mask = torch.cat([mask_clip, tt.attention_mask.bool()], dim=1)
        return {
            "embeddings": seq.float().cpu().numpy(),
            "attn_mask": mask.cpu().numpy(),
            "pooled_embeddings": pooled.float().cpu().numpy(),
            # where the T5 segment starts: the null swap fits the null's CLIP and T5
            # segments on their own (reference sd3.py:187-216 builds nulls per encoder)
            "segment_boundaries": np.asarray([seq_len], np.int32),
        }
