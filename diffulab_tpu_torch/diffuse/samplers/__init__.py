from diffulab_tpu_torch.diffuse.samplers.common import FlowSampler, Sampler, StepResult, unipc_bh2_correction
from diffulab_tpu_torch.diffuse.samplers.flow import DPMSolverPP2M, Euler, EulerMaruyama, Heun, UniPC

__all__ = ["DPMSolverPP2M", "Euler", "EulerMaruyama", "FlowSampler", "Heun", "Sampler", "StepResult", "UniPC",
           "unipc_bh2_correction"]
