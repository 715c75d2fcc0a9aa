from diffulab_tpu_torch.networks.repa.common import REPA
from diffulab_tpu_torch.networks.repa.dinov2 import DinoV2
from diffulab_tpu_torch.networks.repa.dinov3 import DinoV3
from diffulab_tpu_torch.networks.repa.fixed import FixedViT
from diffulab_tpu_torch.networks.repa.perceiver_resampler import PerceiverResampler
from diffulab_tpu_torch.networks.repa.vit import ViTEncoder

__all__ = ["REPA", "DinoV2", "DinoV3", "FixedViT", "PerceiverResampler", "ViTEncoder"]
