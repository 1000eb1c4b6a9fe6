"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: the STD cache's serving step (:mod:`.cache_ops`), LDA topic
inference (:mod:`.topic_score`), the LM's decode attention
(:mod:`.decode_attention`) and the recsys EmbeddingBag
(:mod:`.embedding_bag`).  The CUDA sources live in ``repro_torch/csrc`` and
build at first use, one library per source, all in parallel
(:mod:`repro_torch.kernels._build`)."""
from .cache_ops import probe_and_commit_op
from .decode_attention import decode_attention_op
from .embedding_bag import embedding_bag_op
from .topic_score import topic_score_op

__all__ = [
    "decode_attention_op",
    "embedding_bag_op",
    "probe_and_commit_op",
    "topic_score_op",
]
