from diffulab_tpu_torch.networks.denoisers.common import Denoiser, ModelOutput
from diffulab_tpu_torch.networks.denoisers.mmdit import MMDiT

__all__ = ["Denoiser", "MMDiT", "ModelOutput"]
