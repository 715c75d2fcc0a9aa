from diffulab_tpu_torch.diffuse.samplers.common import (
    FlowSampler,
    GaussianSampler,
    Sampler,
    StepResult,
    unipc_bh2_correction,
)
from diffulab_tpu_torch.diffuse.samplers.flow import DPMSolverPP2M, Euler, EulerMaruyama, Heun, UniPC
from diffulab_tpu_torch.diffuse.samplers.gaussian import DDIM, DDPM, DPMSolverPPGaussian, UniPCGaussian

__all__ = ["DDIM", "DDPM", "DPMSolverPP2M", "DPMSolverPPGaussian", "Euler", "EulerMaruyama", "FlowSampler",
           "GaussianSampler", "Heun", "Sampler", "StepResult", "UniPC", "UniPCGaussian", "unipc_bh2_correction"]
