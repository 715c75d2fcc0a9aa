"""Non-leaky geometric augmentation with conditioning labels, EDM-style
(port of diffulab_tpu/diffuse/augment.py).

Karras et al. (arXiv:2206.00364 §2.5): geometric augmentation is non-leaky
when the applied transform is fed to the model as a conditioning vector; at
sampling time the zero vector selects the clean distribution.

Transforms (each applied independently with probability ``p``): horizontal
flip; a 90-degree rotation, k in {1, 2, 3}; an integer circular translation,
per axis in [-max_shift, max_shift].

Label layout [6] (augment.py:19-27): ``[flip, cos(theta), sin(theta), tx/S,
ty/S, applied]``, zeros for transforms that were not applied; an applied
0-degree rotation would be (1, 0), unlike "no rotation" (0, 0). The label
encodes the whole transform, so :meth:`AugmentPipe.apply` rebuilds it from
the labels alone: the parity tests drive it with the labels the reference's
pipe drew.
"""

from __future__ import annotations

import dataclasses
import math

import torch

AUGMENT_DIM = 6


@dataclasses.dataclass(frozen=True)
class AugmentPipe:
    """Batched augmentation: ``pipe(x, generator)`` -> (augmented x, labels [B, 6]).

    ``x`` is NHWC with H == W (the rotation group needs square grids).
    """

    p: float = 0.12
    max_shift_frac: float = 0.125  # EDM uses 1/8 of the image side

    def draw_labels(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """The [B, 6] fp32 labels of one random draw of the transforms, on x's device."""
        b, h, w, _ = x.shape
        if h != w:
            raise ValueError("AugmentPipe requires square images (90-degree rotations)")
        kw = dict(generator=generator, device=x.device)
        do_flip = torch.rand((b,), **kw) < self.p
        do_rot = torch.rand((b,), **kw) < self.p
        do_trans = torch.rand((b,), **kw) < self.p
        k = torch.where(do_rot, torch.randint(1, 4, (b,), **kw), 0)
        max_shift = max(int(round(self.max_shift_frac * h)), 1)
        tx = torch.where(do_trans, torch.randint(-max_shift, max_shift + 1, (b,), **kw), 0)
        ty = torch.where(do_trans, torch.randint(-max_shift, max_shift + 1, (b,), **kw), 0)
        theta = k.float() * (math.pi / 2.0)
        zero = torch.zeros((), device=x.device)
        return torch.stack([
            do_flip.float(),
            torch.where(do_rot, torch.cos(theta), zero),
            torch.where(do_rot, torch.sin(theta), zero),
            tx.float() / h,
            ty.float() / h,
            (do_flip | do_rot | do_trans).float(),
        ], dim=1)

    @staticmethod
    def apply(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The transform the [B, 6] ``labels`` encode, applied to NHWC ``x``:
        the flip, then ``rot90`` by k in the (H, W) plane (k from the label's
        (cos, sin)), then the circular shift by (ty, tx) rows and columns
        (augment.py:57-84)."""
        b, h, w, _ = x.shape
        expand = (-1,) + (1,) * (x.ndim - 1)
        flip = labels[:, 0] > 0.5
        x = torch.where(flip.reshape(expand), x.flip(2), x)
        # k from (cos, sin): (0, 1) -> 1, (-1, 0) -> 2, (0, -1) -> 3, (0, 0) -> 0
        cos, sin = labels[:, 1].round().long(), labels[:, 2].round().long()
        k = torch.where(sin == 1, 1, torch.where(cos == -1, 2, torch.where(sin == -1, 3, 0)))
        rots = torch.stack([torch.rot90(x, r, (1, 2)) for r in range(4)])  # [4, B, H, W, C]
        x = rots[k, torch.arange(b, device=x.device)]
        tx = torch.round(labels[:, 3] * h).long()
        ty = torch.round(labels[:, 4] * h).long()
        rows = (torch.arange(h, device=x.device)[None, :] - ty[:, None]) % h  # [B, H]
        cols = (torch.arange(w, device=x.device)[None, :] - tx[:, None]) % w  # [B, W]
        x = torch.take_along_dim(x, rows[:, :, None, None], dim=1)
        return torch.take_along_dim(x, cols[:, None, :, None], dim=2)

    def __call__(self, x: torch.Tensor, generator: torch.Generator | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        labels = self.draw_labels(x, generator)
        return self.apply(x, labels), labels
