from diffulab_tpu_torch.diffuse.samplers.common import FlowSampler, Sampler, StepResult
from diffulab_tpu_torch.diffuse.samplers.flow import Euler

__all__ = ["Euler", "FlowSampler", "Sampler", "StepResult"]
