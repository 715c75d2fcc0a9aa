"""Config layer of the port (port of diffulab_tpu/config/): YAML composition,
``_target_`` instantiation with the ``diffulab_tpu.`` -> ``diffulab_tpu_torch.``
remap, and hydra-style sweeps."""

from diffulab_tpu_torch.config.compose import compose_config, load_yaml
from diffulab_tpu_torch.config.instantiate import instantiate

__all__ = ["compose_config", "instantiate", "load_yaml"]
