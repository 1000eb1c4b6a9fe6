"""Config module for gemma-2b (see registry.py for the full spec)."""
from .registry import get_arch

ARCH = get_arch("gemma-2b")
CONFIG = ARCH.config
SMOKE_CONFIG = ARCH.smoke_config
SHAPES = {s.name: s for s in ARCH.shapes}
