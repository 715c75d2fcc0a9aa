from diffulab_tpu_torch.networks.vision_towers.common import VisionTower
from diffulab_tpu_torch.networks.vision_towers.dc_ae import DCAE
from diffulab_tpu_torch.networks.vision_towers.flux2 import Flux2VAE

__all__ = ["DCAE", "Flux2VAE", "VisionTower"]
