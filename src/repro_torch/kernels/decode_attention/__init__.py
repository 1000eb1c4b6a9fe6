"""GQA flash-decode attention over a KV cache: the op, its CUDA kernel's
wrapper (:mod:`.kernel`) and its plain PyTorch version (:mod:`.ref`)."""
from .ops import decode_attention_op
from .ref import decode_attention_plain

__all__ = ["decode_attention_op", "decode_attention_plain"]
