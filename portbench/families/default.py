"""The default model family, of a configuration that names none: a GQA
decoder whose FFN is SwiGLU or a softmax-routed expert layer beside an
optional dense residual FFN (glm4-9b, arctic-480b)."""
from arith import row_flops  # noqa: F401
from harness import transformer_config as program_config  # noqa: F401
from refmodel import Reference  # noqa: F401
from weights import layout  # noqa: F401
