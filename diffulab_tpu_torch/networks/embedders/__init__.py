from diffulab_tpu_torch.networks.embedders.common import ContextEmbedder, ContextEmbedderOutput
from diffulab_tpu_torch.networks.embedders.precomputed import PrecomputedEmbedder

__all__ = ["ContextEmbedder", "ContextEmbedderOutput", "PrecomputedEmbedder"]
