from diffulab_tpu_torch.networks.embedders.common import ContextEmbedder, ContextEmbedderOutput
from diffulab_tpu_torch.networks.embedders.precomputed import PrecomputedEmbedder
from diffulab_tpu_torch.networks.embedders.trainable import TrainableTextEmbedder, byte_tokenize

__all__ = ["ContextEmbedder", "ContextEmbedderOutput", "PrecomputedEmbedder", "TrainableTextEmbedder", "byte_tokenize"]
