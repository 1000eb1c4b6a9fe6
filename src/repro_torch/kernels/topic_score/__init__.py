"""LDA topic inference: the topic-score op, its CUDA kernel's wrapper
(:mod:`.kernel`) and its plain PyTorch version (:mod:`.ref`)."""
from .ops import topic_score_op
from .ref import topic_score_plain

__all__ = ["topic_score_op", "topic_score_plain"]
