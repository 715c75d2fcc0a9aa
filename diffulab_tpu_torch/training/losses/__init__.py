from diffulab_tpu_torch.training.losses.build import build_extra_losses
from diffulab_tpu_torch.training.losses.common import LossFunction
from diffulab_tpu_torch.training.losses.repa import RepaLoss

__all__ = ["LossFunction", "RepaLoss", "build_extra_losses"]
