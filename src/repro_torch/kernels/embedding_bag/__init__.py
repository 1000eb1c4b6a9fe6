"""The recsys EmbeddingBag: the op, its CUDA kernel's wrapper (:mod:`.kernel`)
and its plain PyTorch versions (:mod:`.ref`)."""
from .ops import embedding_bag_op
from .ref import embedding_bag_backward, embedding_bag_plain, embedding_bag_ref

__all__ = ["embedding_bag_backward", "embedding_bag_op", "embedding_bag_plain", "embedding_bag_ref"]
