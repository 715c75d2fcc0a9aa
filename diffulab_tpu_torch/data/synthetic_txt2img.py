"""Compositional captioned scenes, the hard synthetic benchmark (port of
diffulab_tpu/data/synthetic_txt2img.py: pure numpy, the same images, labels,
captions and caption embeddings for the same seed, and the same judge).

Per class (shape), samples vary in object count (imbalanced 0.6/0.3/0.1),
palette color (Zipf-imbalanced over 8), size, free positions and rotations,
and background polarity, at 64x64: intra-class multimodality with rare modes,
so that guidance binds. Rendering uses the signed-distance shapes of
:mod:`diffulab_tpu_torch.data.synthetic`; captions follow a fixed template
over the discrete attributes; caption embeddings are a fixed-seed per-word
Gaussian table; the caption-consistency judge uses pixel statistics and
connected components, no learned model.
"""

from __future__ import annotations

import numpy as np

from diffulab_tpu_torch.data.base import BaseDataset
from diffulab_tpu_torch.data.synthetic import _sdf

# discrete attribute spaces -------------------------------------------------
SHAPES = ("disk", "square", "triangle", "ring", "cross")
COLORS: dict[str, tuple[float, float, float]] = {
    "red": (0.85, 0.15, 0.15),
    "orange": (0.95, 0.55, 0.10),
    "yellow": (0.92, 0.88, 0.15),
    "green": (0.15, 0.75, 0.25),
    "cyan": (0.10, 0.80, 0.85),
    "blue": (0.15, 0.30, 0.90),
    "purple": (0.55, 0.20, 0.85),
    "pink": (0.95, 0.45, 0.70),
}
COLOR_NAMES = tuple(COLORS)
# Zipf-ish imbalance: rare colors are the rare modes guidance must not drop
COLOR_P = np.array([0.28, 0.20, 0.14, 0.11, 0.09, 0.07, 0.06, 0.05])
COUNT_WORDS = ("one", "two", "three")
COUNT_P = np.array([0.6, 0.3, 0.1])
SIZES = ("small", "large")
SIZE_P = np.array([0.5, 0.5])
BACKGROUNDS = ("dark", "light")
BACKGROUND_P = np.array([0.7, 0.3])
_PLURAL = {"disk": "disks", "square": "squares", "triangle": "triangles",
           "ring": "rings", "cross": "crosses"}


def draw_spec(rng: np.random.Generator) -> dict:
    """One imbalanced scene spec."""
    return {
        "count": int(rng.choice(3, p=COUNT_P)) + 1,
        "size": SIZES[int(rng.choice(2, p=SIZE_P))],
        "color": COLOR_NAMES[int(rng.choice(len(COLOR_P), p=COLOR_P))],
        "shape": SHAPES[int(rng.integers(0, len(SHAPES)))],
        "background": BACKGROUNDS[int(rng.choice(2, p=BACKGROUND_P))],
    }


def caption_of(spec: dict) -> str:
    shape = spec["shape"] if spec["count"] == 1 else _PLURAL[spec["shape"]]
    return (f"{COUNT_WORDS[spec['count'] - 1]} {spec['size']} {spec['color']} "
            f"{shape} on a {spec['background']} background")


def parse_caption(caption: str) -> dict:
    """Inverse of :func:`caption_of` (used by the consistency judge)."""
    words = caption.split()
    count = COUNT_WORDS.index(words[0]) + 1
    shape = words[3]
    singular = {v: k for k, v in _PLURAL.items()}.get(shape, shape)
    return {"count": count, "size": words[1], "color": words[2],
            "shape": singular, "background": words[6]}


def render_scene(rng: np.random.Generator, spec: dict, size: int = 64,
                 supersample: int = 2) -> np.ndarray:
    """uint8 [size, size, 3] rendering of ``spec``: ``count`` non-overlapping
    copies of one (shape, color, size) over a gradient background."""
    s = size * supersample
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    xx = (xx + 0.5) / s * 2 - 1
    yy = (yy + 0.5) / s * 2 - 1

    # background: polarity sets the luma band; slight gradient + hue tint
    g_dir = rng.uniform(0.0, 2 * np.pi)
    grad = 0.5 + 0.5 * (np.cos(g_dir) * xx + np.sin(g_dir) * yy) / np.sqrt(2)
    if spec["background"] == "dark":
        lo, hi = rng.uniform(0.04, 0.10), rng.uniform(0.16, 0.26)
    else:
        lo, hi = rng.uniform(0.70, 0.80), rng.uniform(0.86, 0.96)
    tint = 1.0 + rng.uniform(-0.06, 0.06, size=3)
    img = ((lo + (hi - lo) * grad)[..., None] * tint).astype(np.float32)

    base_r = rng.uniform(0.10, 0.15) if spec["size"] == "small" else rng.uniform(0.20, 0.26)
    fg = np.clip(np.asarray(COLORS[spec["color"]]) + rng.uniform(-0.06, 0.06, 3), 0, 1)

    # rejection-place non-overlapping centers; shrink the radius if a crowded
    # draw cannot fit — the CAPTION's count must always be honored (a render
    # with fewer objects than the caption would corrupt both training data
    # and the consistency metric)
    centers: list[tuple[float, float]] = []
    while True:
        margin = base_r + 0.05
        for _ in range(300):
            if len(centers) == spec["count"]:
                break
            cx, cy = rng.uniform(-1 + margin, 1 - margin, size=2)
            if all((cx - ox) ** 2 + (cy - oy) ** 2 > (2.6 * base_r) ** 2 for ox, oy in centers):
                centers.append((cx, cy))
        if len(centers) == spec["count"]:
            break
        centers.clear()
        base_r *= 0.85
    for cx, cy in centers:
        theta = rng.uniform(0.0, 2 * np.pi)
        ct, st = np.cos(theta), np.sin(theta)
        xr = ct * (xx - cx) + st * (yy - cy)
        yr = -st * (xx - cx) + ct * (yy - cy)
        d = _sdf(spec["shape"], xr, yr, base_r * rng.uniform(0.92, 1.08))
        alpha = np.clip(0.5 - d * (s / 4.0), 0.0, 1.0)[..., None]
        img = alpha * fg + (1.0 - alpha) * img

    img = img.reshape(size, supersample, size, supersample, 3).mean(axis=(1, 3))
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------- #
# caption embeddings (the precomputed-embedder conditioning path)
# --------------------------------------------------------------------------- #
VOCAB = sorted(
    set(COUNT_WORDS) | set(SIZES) | set(COLOR_NAMES) | set(SHAPES)
    | set(_PLURAL.values()) | set(BACKGROUNDS) | {"on", "a", "background"}
)
EMB_LEN = 8  # captions are 7 words; one pad slot


def caption_embedding_table(dim: int = 512, seed: int = 97) -> np.ndarray:
    """Fixed-seed Gaussian word embeddings [len(VOCAB), dim] — deterministic,
    injective, frozen: the role a frozen LM plays for the precomputed path."""
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1.0, size=(len(VOCAB), dim)).astype(np.float32)


def embed_captions(captions: list[str], table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[B, EMB_LEN, dim] embeddings + [B, EMB_LEN] mask."""
    idx = {w: i for i, w in enumerate(VOCAB)}
    out = np.zeros((len(captions), EMB_LEN, table.shape[1]), np.float32)
    mask = np.zeros((len(captions), EMB_LEN), bool)
    for i, caption in enumerate(captions):
        words = caption.split()[:EMB_LEN]
        for j, w in enumerate(words):
            out[i, j] = table[idx[w]]
            mask[i, j] = True
    return out, mask


# --------------------------------------------------------------------------- #
# class-conditional view (the guidance-binding benchmark)
# --------------------------------------------------------------------------- #
class SyntheticCompositionalDataset(BaseDataset):
    """Class label = shape (5 classes); everything else — count, color,
    size, background, positions — is free intra-class structure with
    imbalanced (rare) modes. ``specs``/``captions`` ride along for the
    txt2img pipeline and the consistency judge."""

    n_classes = len(SHAPES)

    def __init__(self, data_path: str | None = None, train: bool = True,
                 n_samples: int = 10_000, image_size: int = 64, seed: int = 0):
        super().__init__()
        self.image_size = image_size
        base_seed = seed * 2 + (0 if train else 1)
        rng = np.random.default_rng(np.random.SeedSequence([base_seed, 0xC04D]))
        self.specs = [draw_spec(rng) for _ in range(n_samples)]
        self.captions = [caption_of(s) for s in self.specs]
        self.images = np.stack(
            [render_scene(rng, s, image_size) for s in self.specs]
        )
        self.labels = np.asarray([SHAPES.index(s["shape"]) for s in self.specs], np.int64)

    def load_data(self):
        return self.images, self.labels

    def preprocess_image(self, image: np.ndarray) -> np.ndarray:
        return image.astype(np.float32) / 127.5 - 1.0


# --------------------------------------------------------------------------- #
# deterministic caption-consistency judge
# --------------------------------------------------------------------------- #
def _connected_components(mask: np.ndarray, min_area: int) -> list[np.ndarray]:
    """4-connected components of a bool mask (numpy-only BFS; 64x64 scale)."""
    seen = np.zeros_like(mask, bool)
    comps = []
    h, w = mask.shape
    for sy, sx in zip(*np.nonzero(mask & ~seen)):
        if seen[sy, sx]:
            continue
        stack = [(int(sy), int(sx))]
        seen[sy, sx] = True
        pixels = []
        while stack:
            y, x = stack.pop()
            pixels.append((y, x))
            for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                if 0 <= ny < h and 0 <= nx < w and mask[ny, nx] and not seen[ny, nx]:
                    seen[ny, nx] = True
                    stack.append((ny, nx))
        if len(pixels) >= min_area:
            comps.append(np.asarray(pixels))
    return comps


def _has_hole(c: np.ndarray, mask: np.ndarray) -> bool:
    """Enclosed background inside the component's bbox (ring detector)."""
    from collections import deque

    y0, y1 = c[:, 0].min(), c[:, 0].max()
    x0, x1 = c[:, 1].min(), c[:, 1].max()
    sub = mask[y0 : y1 + 1, x0 : x1 + 1]
    h, w = sub.shape
    seen = np.zeros_like(sub, bool)
    dq: deque = deque()
    for y in range(h):
        for x in (0, w - 1):
            if not sub[y, x] and not seen[y, x]:
                seen[y, x] = True
                dq.append((y, x))
    for x in range(w):
        for y in (0, h - 1):
            if not sub[y, x] and not seen[y, x]:
                seen[y, x] = True
                dq.append((y, x))
    while dq:
        y, x = dq.popleft()
        for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
            if 0 <= ny < h and 0 <= nx < w and not sub[ny, nx] and not seen[ny, nx]:
                seen[ny, nx] = True
                dq.append((ny, nx))
    return (~sub & ~seen).sum() / max(len(c), 1) > 0.08


def _classify_shape(c: np.ndarray, mask: np.ndarray) -> str:
    """Rotation-invariant shape from the smoothed radial max-profile:
    ring = enclosed hole; triangle = 3rd harmonic dominant; then profile
    depth separates disk < square < cross (calibrated on the renderer:
    ~92% per-component accuracy vs 20% chance; see tests)."""
    if _has_hole(c, mask):
        return "ring"
    cy, cx = c.mean(axis=0)
    dy, dx = c[:, 0] - cy, c[:, 1] - cx
    r = np.hypot(dy, dx)
    theta = np.arctan2(dy, dx)
    nb = 24
    bins = ((theta + np.pi) / (2 * np.pi) * nb).astype(int).clip(0, nb - 1)
    prof = np.full(nb, np.nan)
    for b in range(nb):
        sel = r[bins == b]
        if len(sel):
            prof[b] = sel.max()
    prof = prof[~np.isnan(prof)]
    if len(prof) < 6:
        return "disk"
    k = np.r_[prof[-1:], prof, prof[:1]]
    smooth = (k[:-2] + k[1:-1] + k[2:]) / 3
    smooth = smooth / (smooth.mean() + 1e-9)
    depth = smooth.max() - smooth.min()
    spectrum = np.abs(np.fft.rfft(smooth - smooth.mean()))
    a3 = spectrum[3] if len(spectrum) > 3 else 0.0
    a4 = spectrum[4] if len(spectrum) > 4 else 0.0
    if a3 > a4 and depth > 0.4:
        return "triangle"
    if depth < 0.17:
        return "disk"
    return "cross" if depth > 0.36 else "square"


def judge_image(image_pm1: np.ndarray) -> dict:
    """Estimate (color, count, size, background, shape) of a [-1,1] RGB image
    via pixel statistics — no learned models, so the metric is reproducible
    and un-gameable by the feature space."""
    img = np.clip(image_pm1 * 0.5 + 0.5, 0.0, 1.0).astype(np.float32)
    border = np.concatenate([img[0], img[-1], img[:, 0], img[:, -1]])
    bg_color = np.median(border, axis=0)
    bg_luma = float(bg_color @ np.asarray([0.299, 0.587, 0.114]))
    background = "dark" if bg_luma < 0.5 else "light"

    # object mask: pixels far from the background estimate
    dist = np.linalg.norm(img - bg_color, axis=-1)
    mask = dist > 0.25
    h = img.shape[0]
    min_area = max(8, (h // 16) ** 2)
    comps = _connected_components(mask, min_area)
    count = len(comps)
    if count == 0:
        return {"color": None, "count": 0, "size": None, "background": background,
                "shape": None}

    areas = [len(c) for c in comps]
    obj_pixels = np.concatenate([img[c[:, 0], c[:, 1]] for c in comps])
    mean_rgb = obj_pixels.mean(axis=0)
    palette = np.asarray(list(COLORS.values()), np.float32)
    color = COLOR_NAMES[int(np.argmin(np.linalg.norm(palette - mean_rgb, axis=-1)))]
    # size threshold: "small" radius is 0.10-0.15 of the half-width, "large"
    # 0.20-0.26 -> cut at the midpoint radius 0.175
    mean_area = float(np.mean(areas))
    size_cut = np.pi * (0.175 * h / 2) ** 2
    size = "small" if mean_area < size_cut else "large"
    from collections import Counter

    shape = Counter(_classify_shape(c, mask) for c in comps).most_common(1)[0][0]
    return {"color": color, "count": count, "size": size, "background": background,
            "shape": shape}


def caption_consistency(images_pm1: np.ndarray, captions: list[str]) -> dict[str, float]:
    """Per-attribute accuracy of generated images against their captions.

    ``all`` requires every attribute including shape. Metric ceilings on
    clean renders: color/count/background ~1.0, size ~0.92, shape ~0.92."""
    attrs = ("color", "count", "size", "background", "shape")
    hits = {k: 0 for k in (*attrs, "all")}
    for img, caption in zip(images_pm1, captions):
        want = parse_caption(caption)
        got = judge_image(img)
        ok = {k: got[k] == want[k] for k in attrs}
        for k, v in ok.items():
            hits[k] += v
        hits["all"] += all(ok.values())
    n = max(len(captions), 1)
    return {k: v / n for k, v in hits.items()}
