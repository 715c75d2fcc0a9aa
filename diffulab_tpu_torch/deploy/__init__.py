from diffulab_tpu_torch.deploy.export import DeployedSampler, TensorSpec, export_generate

__all__ = ["DeployedSampler", "TensorSpec", "export_generate"]
