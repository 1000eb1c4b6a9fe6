"""Config module for --arch llama4-scout-17b-a16e (see registry.py for the full spec)."""
from .registry import get_arch

ARCH = get_arch("llama4-scout-17b-a16e")
CONFIG = ARCH.config
SMOKE_CONFIG = ARCH.smoke_config
SHAPES = {s.name: s for s in ARCH.shapes}
