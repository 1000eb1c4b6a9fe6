"""Architecture configs of the port: the LM registry and gemma-2b's module."""
from .registry import ARCHS, Arch, ShapeSpec, get_arch

__all__ = ["ARCHS", "Arch", "ShapeSpec", "get_arch"]
