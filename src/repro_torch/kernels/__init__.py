"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: the STD cache's serving step (:mod:`.cache_ops`), LDA topic
inference (:mod:`.topic_score`), the LM's decode attention
(:mod:`.decode_attention`) and the recsys EmbeddingBag
(:mod:`.embedding_bag`).  The CUDA sources live in ``repro_torch/csrc`` and
build at first use, one library per source, all in parallel
(:mod:`repro_torch.kernels._build`)."""
from .embedding_bag import embedding_bag_op

__all__ = ["embedding_bag_op"]
