from diffulab_tpu_torch.networks.rewards.common import RewardModel
from diffulab_tpu_torch.networks.rewards.grpo import LumaJudge, PrefGRPORewardModel

__all__ = ["LumaJudge", "PrefGRPORewardModel", "RewardModel"]
