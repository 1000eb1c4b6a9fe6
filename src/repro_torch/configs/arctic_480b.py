"""Config module for --arch arctic-480b (see registry.py for the full spec)."""
from .registry import get_arch

ARCH = get_arch("arctic-480b")
CONFIG = ARCH.config
SMOKE_CONFIG = ARCH.smoke_config
SHAPES = {s.name: s for s in ARCH.shapes}
