"""Host-side pieces of the cache shared by the port's modules."""
from .alloc import allocation_divergence, proportional_allocation, uniform_allocation
from .device import resolve_device
from .spec import PAD_KEY, AdmissionSpec, CacheSpec, DynamicSpec, StaticSpec, TopicLayerSpec

__all__ = [
    "PAD_KEY",
    "AdmissionSpec",
    "CacheSpec",
    "DynamicSpec",
    "StaticSpec",
    "TopicLayerSpec",
    "allocation_divergence",
    "proportional_allocation",
    "resolve_device",
    "uniform_allocation",
]
