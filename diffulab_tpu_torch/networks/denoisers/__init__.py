from diffulab_tpu_torch.networks.denoisers.common import Denoiser, ModelOutput
from diffulab_tpu_torch.networks.denoisers.ddt import DDT
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT
from diffulab_tpu_torch.networks.denoisers.sprint import SprintDiT
from diffulab_tpu_torch.networks.denoisers.unet import UNetModel

__all__ = ["DDT", "Denoiser", "MMDiT", "ModelOutput", "SprintDiT", "UNetModel"]
