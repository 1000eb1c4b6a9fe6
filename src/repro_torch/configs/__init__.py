"""Architecture configs of the port: the LM and recsys registry and a
module per served architecture."""
from .registry import ARCHS, Arch, ShapeSpec, get_arch

__all__ = ["ARCHS", "Arch", "ShapeSpec", "get_arch"]
