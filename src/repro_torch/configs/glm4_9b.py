"""Config module for --arch glm4-9b (see registry.py for the full spec)."""
from .registry import get_arch

ARCH = get_arch("glm4-9b")
CONFIG = ARCH.config
SMOKE_CONFIG = ARCH.smoke_config
SHAPES = {s.name: s for s in ARCH.shapes}
