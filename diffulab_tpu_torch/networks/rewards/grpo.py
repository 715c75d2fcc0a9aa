"""PrefGRPO reward model: VLM pairwise-preference advantages (port of
diffulab_tpu/networks/rewards/grpo.py; reference
src/diffulab/networks/rewards/grpo.py:43-529).

The JAX package's module imports no JAX: the aggregation is NumPy, and the
port keeps its own copy of it:

- all unordered image pairs per prompt (reference :384-386);
- judge outputs parsed either as CoT ``<answer>Image k is better</answer>`` or
  per-dimension relative score blocks summed per image (reference :90-162,
  :235-254);
- per-image win rates (ties split 0.5), zero-comparison images get 0;
- z-score standardization per prompt or global, std clamped at 1e-6;
- optional CLIP-similarity reward blended ``lambda_base*pref +
  lambda_clip*clip`` (reference :419-471, :520-526);
- advantages clamped to ``+-advantage_clip_max``.

The judge is pluggable: ``judge(messages) -> list[str]`` where each message
is ``(image_1, image_2, prompt)`` with uint8 HWC images. :class:`LumaJudge`
is an offline judge with a real preference (the brighter image wins);
:class:`VLMJudge` wraps a local UnifiedReward Qwen2.5-VL checkpoint and
:class:`CLIPScorer` a CLIP model, both through ``transformers``, which they
import only when they load: the module imports without it, and a run that
asks for either without it fails with that ``ImportError``.
"""

from __future__ import annotations

import itertools
import re
from typing import Callable, Sequence

import numpy as np

from diffulab_tpu_torch.networks.rewards.common import RewardModel

JudgeFn = Callable[[Sequence[tuple[np.ndarray, np.ndarray, str]]], list[str]]
ClipScoreFn = Callable[[np.ndarray, Sequence[str]], np.ndarray]

MODEL_REGISTRY = {
    "cot_7b": "CodeGoat24/UnifiedReward-Think-qwen-7b",
    "3b": "CodeGoat24/UnifiedReward-2.0-qwen-3b",
    "7b": "CodeGoat24/UnifiedReward-2.0-qwen-7b",
    "32b": "CodeGoat24/UnifiedReward-2.0-qwen-32b",
    "72b": "CodeGoat24/UnifiedReward-2.0-qwen-72b",
}


def to_uint8_image(image: np.ndarray) -> np.ndarray:
    """[-1,1] float HWC -> uint8 HWC (reference convert_to_image, :165-178)."""
    return (np.clip(image * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)


def pairwise_template(prompt: str, use_cot: bool) -> str:
    """The judge instruction (reference get_template, :180-218)."""
    if use_cot:
        return (
            "Given a caption and two images generated from it, evaluate both images across "
            "dimensions such as semantic consistency with the caption, aesthetics, and "
            "authenticity. Score each image 1-10 per dimension, reason step by step inside "
            "<think></think> tags, sum the totals, then output exactly 'Image 1 is better' or "
            "'Image 2 is better' inside an <answer></answer> tag with no additional text.\n\n"
            f"Text Caption: [{prompt}]"
        )
    return (
        "You are presented with two generated images (Image 1 and Image 2) and a shared text "
        "caption. Comparatively evaluate them on three dimensions - Alignment Score (caption "
        "match), Coherence Score (visual consistency, absence of glitches), and Style Score "
        "(aesthetics). For each dimension assign relative float scores in [0,1] to Image 1 and "
        "Image 2 summing to exactly 1.0, higher meaning better. Reply exactly in the format:\n\n"
        "Alignment Score:\n Image 1: X\n Image 2: Y\n\n"
        "Coherence Score:\n Image 1: X\n Image 2: Y\n\n"
        "Style Score:\n Image 1: X\n Image 2: Y\n\n"
        f"Text Caption: [{prompt}]"
    )


class PrefGRPORewardModel(RewardModel):
    model_registry = MODEL_REGISTRY

    def __init__(
        self,
        version: str = "7b",
        n_image_per_prompt: int = 16,
        advantage_clip_max: float = 5.0,
        use_clip: bool = False,
        lambda_base: float = 0.7,
        lambda_clip: float = 1.4,
        clip_model_id: str = "laion/CLIP-ViT-H-14-laion2B-s32B-b79K",
        judge: JudgeFn | None = None,
        clip_scorer: ClipScoreFn | None = None,
        model_path: str | None = None,
    ):
        super().__init__(n_image_per_prompt)
        if version not in self.model_registry:
            raise ValueError(f"Unsupported model version: {version}, available: {list(self.model_registry)}")
        self.version = version
        self.use_cot = version.startswith("cot")
        self.advantage_clip_max = advantage_clip_max
        self.use_clip = use_clip
        self.lambda_base = lambda_base
        self.lambda_clip = lambda_clip

        if judge is None:
            judge = VLMJudge(model_path or self.model_registry[version], use_cot=self.use_cot)
        self.judge = judge
        if use_clip and clip_scorer is None:
            clip_scorer = CLIPScorer(clip_model_id)
        self.clip_scorer = clip_scorer

    # --- parsing (reference :90-162, :235-254) -----------------------------
    @staticmethod
    def _extract_cot_answer(text: str) -> str | None:
        match = re.search(r"<answer>(.*?)</answer>", text, re.DOTALL | re.IGNORECASE)
        return match.group(1).strip() if match else None

    @staticmethod
    def _parse_scores(raw: str) -> dict[str, dict[str, float]]:
        text = bytes(raw, "utf-8").decode("unicode_escape") if "\\n" in raw else raw
        sections: dict[str, dict[str, float]] = {}
        current = None
        for line in text.strip().splitlines():
            line = line.strip()
            if not line:
                continue
            m = re.match(r"^(.*?\S)\s*:\s*$", line)
            if m and "Score" in m.group(1):
                current = m.group(1)
                sections[current] = {}
                continue
            m = re.match(r"^Image\s+(\d+)\s*:\s*([+-]?\d+(?:\.\d+)?)$", line)
            if m and current:
                sections[current][f"Image {m.group(1)}"] = float(m.group(2))
        return sections

    def _assess_winner(self, output: str) -> int | None:
        if self.use_cot:
            answer = (self._extract_cot_answer(output) or output).lower()
            if "image 1 is better" in answer:
                return 0
            if "image 2 is better" in answer:
                return 1
            return None
        scores = self._parse_scores(output)
        if not scores:
            return None
        total1 = sum(s.get("Image 1", 0.0) for s in scores.values())
        total2 = sum(s.get("Image 2", 0.0) for s in scores.values())
        if total1 > total2:
            return 0
        if total2 > total1:
            return 1
        return None

    # --- aggregation (reference :256-339) ----------------------------------
    def parse_and_aggregate(
        self, outputs: list[str], pairs: np.ndarray, n_prompts: int
    ) -> tuple[np.ndarray, np.ndarray]:
        n_pairs = pairs.shape[0]
        win = np.zeros((n_prompts, self.n_image_per_prompt), np.float32)
        cnt = np.zeros((n_prompts, self.n_image_per_prompt), np.int32)
        for i, output in enumerate(outputs):
            p, j = divmod(i, n_pairs)
            i1, i2 = int(pairs[j, 0]), int(pairs[j, 1])
            cnt[p, i1] += 1
            cnt[p, i2] += 1
            winner = self._assess_winner(output)
            if winner is None:
                win[p, i1] += 0.5
                win[p, i2] += 0.5
            elif winner == 0:
                win[p, i1] += 1.0
            else:
                win[p, i2] += 1.0
        return win, cnt

    @staticmethod
    def compute_advantages(advantages: np.ndarray, advantage_per_prompt: bool = True) -> np.ndarray:
        if advantage_per_prompt:
            mean = advantages.mean(axis=1, keepdims=True)
            std = np.clip(advantages.std(axis=1, keepdims=True), 1e-6, None)
        else:
            mean = advantages.mean()
            std = max(float(advantages.std()), 1e-6)
        return (advantages - mean) / std

    # --- main entry (reference forward, :473-529) ---------------------------
    def __call__(self, images: np.ndarray, context: Sequence[str],
                 advantage_per_prompt: bool = True) -> np.ndarray:
        """images [B, H, W, C] in [-1,1]; context: one prompt per GROUP (B/N).
        A batch that does not split into whole groups, or a context of another
        length, raises ``ValueError`` (an ``AssertionError`` in the reference)."""
        images = np.asarray(images)
        b = images.shape[0]
        n = self.n_image_per_prompt
        if b % n != 0:
            raise ValueError(f"batch {b} not divisible by n_image_per_prompt {n}")
        n_prompts = b // n
        if len(context) != n_prompts:
            raise ValueError(f"context length {len(context)} != number of prompts {n_prompts}")
        grouped = images.reshape(n_prompts, n, *images.shape[1:])

        pairs = np.array(list(itertools.combinations(range(n), 2)), np.int64)
        queries: list[tuple[np.ndarray, np.ndarray, str]] = []
        for p in range(n_prompts):
            for i1, i2 in pairs:
                queries.append((to_uint8_image(grouped[p, i1]),
                                to_uint8_image(grouped[p, i2]), str(context[p])))
        outputs = self.judge(queries)

        win, cnt = self.parse_and_aggregate(outputs, pairs, n_prompts)
        win_rate = np.where(cnt > 0, win / np.maximum(cnt, 1), 0.0).astype(np.float32)
        advantages = self.compute_advantages(win_rate, advantage_per_prompt)

        if self.use_clip:
            flat_context = [str(context[p]) for p in range(n_prompts) for _ in range(n)]
            clip_scores = np.asarray(
                self.clip_scorer(images.reshape(b, *images.shape[1:]), flat_context), np.float32
            ).reshape(n_prompts, n)
            clip_adv = self.compute_advantages(clip_scores, advantage_per_prompt)
            advantages = self.lambda_base * advantages + self.lambda_clip * clip_adv

        advantages = np.clip(advantages, -self.advantage_clip_max, self.advantage_clip_max)
        return advantages.reshape(b)

    def raw_metrics(self, images: np.ndarray, context: Sequence[str]) -> dict[str, float]:
        """Un-normalized quality metrics for learning curves (z-scored
        advantages are ~0-mean by construction, so they cannot show whether
        the policy's absolute reward improves). Judges exposing
        ``image_score(uint8_img) -> float`` (e.g. :class:`LumaJudge`)
        contribute a mean score; VLM judges have no absolute scale."""
        del context
        score = getattr(self.judge, "image_score", None)
        if score is None:
            return {}
        values = [score(to_uint8_image(np.asarray(img))) for img in np.asarray(images)]
        return {"judge_score": float(np.mean(values))}


class LumaJudge:
    """Deterministic pairwise judge with a REAL in-image preference: the
    brighter image (higher mean Rec.601 luma) wins. Unlike the constant stub
    judge, maximizing this preference changes the policy measurably: a GRPO run
    trained against it tracks ``image_score`` rising over epochs. Replies use the same score-block
    format the VLM judge emits, so the full parse -> win-rate -> z-score
    aggregation path is exercised.
    """

    @staticmethod
    def image_score(image: np.ndarray) -> float:
        """Mean luma in [0, 1] of a uint8 HWC image."""
        img = np.asarray(image, np.float32) / 255.0
        if img.ndim == 3 and img.shape[-1] == 3:
            img = img @ np.array([0.299, 0.587, 0.114], np.float32)
        return float(img.mean())

    def __call__(self, queries: Sequence[tuple[np.ndarray, np.ndarray, str]]) -> list[str]:
        outs = []
        for i1, i2, _prompt in queries:
            s1 = self.image_score(i1)
            s2 = self.image_score(i2)
            total = max(s1 + s2, 1e-6)
            a, b = s1 / total, s2 / total
            outs.append(
                f"Alignment Score:\nImage 1: {a:.4f}\nImage 2: {b:.4f}\n"
                f"Coherence Score:\nImage 1: {a:.4f}\nImage 2: {b:.4f}\n"
                f"Style Score:\nImage 1: {a:.4f}\nImage 2: {b:.4f}"
            )
        return outs


class VLMJudge:
    """Host-side UnifiedReward Qwen2.5-VL pairwise judge (gated on torch +
    transformers + locally available weights; reference :69-75, :389-413)."""

    def __init__(self, model_path: str, use_cot: bool = False, max_new_tokens: int = 4096,
                 batch_size: int = 8):
        self.model_path = model_path
        self.use_cot = use_cot
        self.max_new_tokens = max_new_tokens
        self.batch_size = batch_size
        self._model = None
        self._processor = None

    def _load(self):
        if self._model is not None:
            return
        from transformers import AutoProcessor, Qwen2_5_VLForConditionalGeneration  # noqa: PLC0415

        self._model = Qwen2_5_VLForConditionalGeneration.from_pretrained(
            self.model_path, dtype="auto"
        ).eval()
        self._processor = AutoProcessor.from_pretrained(self.model_path)

    def __call__(self, queries: Sequence[tuple[np.ndarray, np.ndarray, str]]) -> list[str]:
        self._load()
        from PIL import Image  # noqa: PLC0415

        outputs: list[str] = []
        for start in range(0, len(queries), self.batch_size):
            chunk = queries[start : start + self.batch_size]
            messages = [
                [{
                    "role": "user",
                    "content": [
                        {"type": "image", "image": Image.fromarray(i1)},
                        {"type": "image", "image": Image.fromarray(i2)},
                        {"type": "text", "text": pairwise_template(prompt, self.use_cot)},
                    ],
                }]
                for i1, i2, prompt in chunk
            ]
            chat = self._processor.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True
            )
            image_inputs = [
                img for i1, i2, _ in chunk
                for img in (Image.fromarray(i1), Image.fromarray(i2))
            ]
            inputs = self._processor(text=chat, images=image_inputs,
                                     return_tensors="pt", padding=True)
            generated = self._model.generate(**inputs, max_new_tokens=self.max_new_tokens)
            trimmed = [out[len(inp):] for inp, out in zip(inputs["input_ids"], generated)]
            outputs.extend(self._processor.batch_decode(trimmed, skip_special_tokens=True))
        return outputs


class CLIPScorer:
    """Host-side CLIP image-text cosine similarity (reference :419-471)."""

    def __init__(self, model_id: str, batch_size: int = 16):
        self.model_id = model_id
        self.batch_size = batch_size
        self._model = None
        self._processor = None

    def _load(self):
        if self._model is not None:
            return
        from transformers import CLIPModel, CLIPProcessor  # noqa: PLC0415

        self._model = CLIPModel.from_pretrained(self.model_id).eval()
        self._processor = CLIPProcessor.from_pretrained(self.model_id)

    def __call__(self, images: np.ndarray, context: Sequence[str]) -> np.ndarray:
        self._load()
        import torch  # noqa: PLC0415
        from PIL import Image  # noqa: PLC0415

        sims = np.zeros((len(images),), np.float32)
        with torch.inference_mode():
            for start in range(0, len(images), self.batch_size):
                imgs = [Image.fromarray(to_uint8_image(im))
                        for im in images[start : start + self.batch_size]]
                texts = list(context[start : start + self.batch_size])
                inputs = self._processor(text=texts, images=imgs,
                                         return_tensors="pt", padding=True)
                out = self._model(**inputs)
                cos = (out.logits_per_image / self._model.logit_scale.exp()).diagonal()
                sims[start : start + len(imgs)] = cos.float().numpy()
        return sims
