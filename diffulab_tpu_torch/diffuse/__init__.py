from diffulab_tpu_torch.diffuse.diffuser import Diffuser
from diffulab_tpu_torch.diffuse.flow import Flow
from diffulab_tpu_torch.diffuse.gaussian_diffusion import GaussianDiffusion
from diffulab_tpu_torch.diffuse.schedules import flow_linear_timesteps, shift_timestep

__all__ = ["Diffuser", "Flow", "GaussianDiffusion", "flow_linear_timesteps", "shift_timestep"]
