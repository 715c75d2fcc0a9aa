from diffulab_tpu_torch.networks.denoisers.common import Denoiser, ModelOutput
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.networks.denoisers.unet import UNetModel

__all__ = ["Denoiser", "MMDiT", "ModelOutput", "UNetModel"]
