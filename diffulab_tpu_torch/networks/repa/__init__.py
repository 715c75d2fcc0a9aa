from diffulab_tpu_torch.networks.repa.common import REPA
from diffulab_tpu_torch.networks.repa.fixed import FixedViT
from diffulab_tpu_torch.networks.repa.vit import ViTEncoder

__all__ = ["REPA", "FixedViT", "ViTEncoder"]
