"""Sample-quality evaluation: FID (Frechet distance) over pluggable features
(port of diffulab_tpu/training/evaluation.py).

    FID = |mu_r - mu_f|^2 + tr(C_r + C_f - 2 (C_r C_f)^{1/2})

with the matrix square root from an eigendecomposition of a symmetrised
product. The statistics, FID, KID and precision/recall/density/coverage
are the reference's NumPy code (float64 where it accumulates in float64),
kept here as the port's own copy. Features come from any callable mapping
image batches to ``[B, D]`` vectors: :func:`frozen_vit_features`, the
evaluate CLIs' space, is a ViT-S/4 whose random weights are the ones the
JAX package draws from ``nnx.Rngs(1234)``, reproduced by
:meth:`~diffulab_tpu_torch.networks.repa.vit.ViTEncoder.draw_jax_params`
(trap T24), so ``FEATURE_SPACE_VERSION`` names the same space in both
packages; or a DINOv2 encoder (:func:`dinov2_features`).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from diffulab_tpu_torch.training.trainer import _fold_seed

FeatureFn = Callable[[np.ndarray], np.ndarray]


def _matrix_sqrt_psd(mat: np.ndarray) -> np.ndarray:
    """Square root of a (nearly) PSD symmetric matrix via eigendecomposition."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """Frechet distance between two Gaussians; tr((C1 C2)^{1/2}) as
    tr((C1^{1/2} C2 C1^{1/2})^{1/2}), symmetric PSD by construction."""
    diff = mu1 - mu2
    s1_half = _matrix_sqrt_psd(sigma1)
    covmean = _matrix_sqrt_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


def feature_statistics(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mean, covariance) of [N, D] features (fp64 accumulation)."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def compute_fid(real_features: np.ndarray, fake_features: np.ndarray) -> float:
    mu_r, sig_r = feature_statistics(real_features)
    mu_f, sig_f = feature_statistics(fake_features)
    return frechet_distance(mu_r, sig_r, mu_f, sig_f)


def _pairwise_sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared euclidean distances [N, M] between feature rows (fp32)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    a2 = (a * a).sum(axis=1)[:, None]
    b2 = (b * b).sum(axis=1)[None, :]
    return np.maximum(a2 + b2 - 2.0 * (a @ b.T), 0.0)


def _knn_sq_radii(features: np.ndarray, k: int, chunk: int = 2048) -> np.ndarray:
    """Per-point squared distance to its k-th nearest neighbour (self
    excluded), streamed in row blocks (O(chunk * N) memory)."""
    features = np.asarray(features, np.float32)
    n = len(features)
    radii = np.empty(n, np.float32)
    for start in range(0, n, chunk):
        d = _pairwise_sq_dists(features[start:start + chunk], features)
        d[np.arange(d.shape[0]), np.arange(start, start + d.shape[0])] = np.inf
        radii[start:start + d.shape[0]] = np.partition(d, k - 1, axis=1)[:, k - 1]
    return radii


def compute_precision_recall(real_features: np.ndarray, fake_features: np.ndarray, k: int = 3,
                             chunk: int = 2048) -> dict[str, float]:
    """Improved precision/recall (Kynkaanniemi et al., arXiv:1904.06991) and
    density/coverage (Naeem et al., arXiv:2002.09797) over k-NN balls; the
    cross-set distances stream in fake-row blocks."""
    real_features = np.asarray(real_features, np.float32)
    fake_features = np.asarray(fake_features, np.float32)
    radii_real = _knn_sq_radii(real_features, k, chunk)
    radii_fake = _knn_sq_radii(fake_features, k, chunk)
    m, n = len(fake_features), len(real_features)
    in_any_real = np.zeros(m, bool)          # precision: fake inside a real ball
    ball_counts = np.zeros(m, np.int64)      # density: overlapping real balls
    min_to_fake = np.full(n, np.inf, np.float32)  # coverage: per-real nearest fake
    real_covered = np.zeros(n, bool)         # recall: real inside a fake ball
    for start in range(0, m, chunk):
        d = _pairwise_sq_dists(fake_features[start:start + chunk], real_features)
        in_real_balls = d <= radii_real[None, :]
        in_any_real[start:start + d.shape[0]] = in_real_balls.any(axis=1)
        ball_counts[start:start + d.shape[0]] = in_real_balls.sum(axis=1)
        np.minimum(min_to_fake, d.min(axis=0), out=min_to_fake)
        real_covered |= (d <= radii_fake[start:start + d.shape[0], None]).any(axis=0)
    return {"precision": float(in_any_real.mean()),
            "recall": float(real_covered.mean()),
            "density": float(ball_counts.mean() / k),
            "coverage": float((min_to_fake <= radii_real).mean())}


def compute_kid(real_features: np.ndarray, fake_features: np.ndarray, subset_size: int = 1000,
                n_subsets: int = 100, seed: int = 0) -> dict[str, float]:
    """Kernel Inception Distance (Binkowski et al., arXiv:1801.01401): the
    unbiased MMD^2 with the kernel (x.y / d + 1)^3 over ``n_subsets`` random
    subsets; mean and standard error, deterministic per seed."""
    real = np.asarray(real_features, np.float64)
    fake = np.asarray(fake_features, np.float64)
    d = real.shape[1]
    m = min(subset_size, len(real), len(fake))
    rng = np.random.default_rng(seed)
    scores = np.empty(n_subsets)
    for i in range(n_subsets):
        xr = real[rng.choice(len(real), m, replace=False)]
        xf = fake[rng.choice(len(fake), m, replace=False)]
        k_rr = (xr @ xr.T / d + 1.0) ** 3
        k_ff = (xf @ xf.T / d + 1.0) ** 3
        k_rf = (xr @ xf.T / d + 1.0) ** 3
        sum_rr = (k_rr.sum() - np.trace(k_rr)) / (m * (m - 1))
        sum_ff = (k_ff.sum() - np.trace(k_ff)) / (m * (m - 1))
        scores[i] = sum_rr + sum_ff - 2.0 * k_rf.mean()
    return {"kid": float(scores.mean()), "kid_std": float(scores.std() / np.sqrt(n_subsets))}


def extract_features(images: Iterable[np.ndarray], feature_fn: FeatureFn, batch_size: int = 64) -> np.ndarray:
    """Run a feature fn over image batches; images NHWC in [-1, 1] or [0, 1]."""
    chunks = []
    buffer: list[np.ndarray] = []
    for img in images:
        buffer.append(np.asarray(img))
        if len(buffer) == batch_size:
            chunks.append(np.asarray(feature_fn(np.stack(buffer))))
            buffer = []
    if buffer:
        chunks.append(np.asarray(feature_fn(np.stack(buffer))))
    return np.concatenate(chunks, axis=0)


def _module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def dinov2_features(encoder: torch.nn.Module) -> FeatureFn:
    """Mean-pooled DINOv2 patch features as the FID feature space (FDD);
    [-1, 1] input is mapped to [0, 1] first (evaluation.py:190)."""
    device = _module_device(encoder)

    def fn(batch: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(batch, np.float32), device=device)
        if float(x.min()) < 0:
            x = (x * 0.5 + 0.5).clamp(0.0, 1.0)
        with torch.no_grad():
            return encoder(x).mean(dim=1).float().cpu().numpy()

    return fn


def sample_batches(diffuser, cond_fn: Callable[[int, int], dict], n: int, batch_size: int,
                   data_shape: tuple[int, ...], seed: int = 0, device: str | torch.device | None = None,
                   **generate_kwargs) -> np.ndarray:
    """``n`` samples of ``diffuser.generate(..., clamp_x=True)`` in batches
    of ``batch_size`` as one float32 array [n, *data_shape]: batch
    ``start``'s condition is ``cond_fn(start, size)`` and its draws come from
    a generator seeded from (``seed``, ``start``), as the reference folds
    ``start`` into its key; ``generate_kwargs`` (``guidance_scale``,
    ``guide_denoiser``) go to every call."""
    device = torch.device(device) if device is not None else _module_device(diffuser.denoiser)
    fakes = []
    for start in range(0, n, batch_size):
        bsz = min(batch_size, n - start)
        out = diffuser.generate(cond_fn(start, bsz), data_shape=(bsz, *data_shape), clamp_x=True, device=device,
                                generator=torch.Generator(device=device).manual_seed(_fold_seed(seed, start)),
                                **generate_kwargs)
        fakes.append(out["x"].float().cpu().numpy())
    return np.concatenate(fakes)[:n]


def evaluate_fid(diffuser, real_images: np.ndarray, cond: dict, feature_fn: FeatureFn, n_samples: int | None = None,
                 batch_size: int = 32, guidance_scale: float = 0.0, seed: int = 0,
                 data_shape: tuple[int, ...] | None = None, device: str | torch.device | None = None) -> float:
    """Sample from the diffuser (:func:`sample_batches`, batch ``start``
    conditioned on ``cond``'s rows from ``start`` modulo the real images)
    and compute FID against ``real_images`` (evaluation.py:193-221)."""
    device = torch.device(device) if device is not None else _module_device(diffuser.denoiser)
    n = n_samples or len(real_images)

    def cond_fn(start: int, bsz: int) -> dict:
        return {k: torch.as_tensor(np.asarray(v)[start % len(real_images):][:bsz], device=device)
                for k, v in cond.items()}

    fake = sample_batches(diffuser, cond_fn, n, batch_size, data_shape or real_images.shape[1:], seed, device,
                          guidance_scale=guidance_scale)
    real_feats = extract_features(real_images[:n], feature_fn, batch_size)
    fake_feats = extract_features(fake, feature_fn, batch_size)
    return compute_fid(real_feats, fake_feats)


#: bumped whenever frozen_vit_features changes in any way (architecture, seed, pooling,
#: preprocessing); it keys the real-feature caches. The JAX package's string, for the same space.
FEATURE_SPACE_VERSION = "vit_s4_seed1234_meanpool_v1"


def frozen_vit(image_size: int, feature_seed: int = 1234, device: str | torch.device | None = None):
    """The ViT-S/4 of :func:`frozen_vit_features` with the JAX draw of
    ``nnx.Rngs(feature_seed)`` loaded, in eval mode (evaluation.py:245:
    patch 4, width 384, 6 blocks of 6 heads, no register tokens, no
    LayerScale, the final norm affine)."""
    from diffulab_tpu_torch.networks.repa.vit import ViTEncoder

    enc = ViTEncoder(img_size=image_size, patch_size=4, embed_dim=384, depth=6, num_heads=6,
                     num_register_tokens=0, layerscale=False, device=device)
    enc.draw_jax_params(feature_seed)
    return enc.eval().requires_grad_(False)


def frozen_vit_features(image_size: int, feature_seed: int = 1234,
                        device: str | torch.device | None = None) -> FeatureFn:
    """Mean-pooled patch features of a frozen, fixed-seed ViT-S/4
    (evaluation.py:230-260) on ``device`` (default the card); grayscale
    input is tiled to RGB. Its attention is SDPA (the reference's is XLA's
    own, not a Pallas kernel). The encoder is the function's ``encoder``
    attribute."""
    enc = frozen_vit(image_size, feature_seed, device)
    dev = _module_device(enc)

    def fn(batch: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(batch, np.float32), device=dev)  # [-1, 1] NHWC
        if x.shape[-1] == 1:  # grayscale datasets (MNIST): tile to RGB
            x = x.repeat(1, 1, 1, 3)
        with torch.no_grad():
            return enc(x)["patch_tokens"].mean(dim=1).cpu().numpy()

    fn.encoder = enc
    return fn
