"""Host-side pieces of the cache shared by the port's modules."""
from .alloc import proportional_allocation
from .device import resolve_device
from .spec import PAD_KEY

__all__ = ["PAD_KEY", "proportional_allocation", "resolve_device"]
