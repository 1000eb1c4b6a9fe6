"""Serving runtime of the port: the device-resident STD cache and the
broker's fused serving paths (see :mod:`.broker` for what is not ported
yet)."""
from .broker import Backend, Broker, BrokerStats, HedgePolicy
from .device_cache import (
    DYNAMIC,
    PAD_H64,
    PAD_HI,
    PAD_LO,
    DeviceCacheConfig,
    STDDeviceCache,
    pack_hashes,
    pad_batch,
    splitmix64,
    state_from_numpy,
    state_to_numpy,
)
from .spec import BucketSpec
from ..core.spec import PAD_KEY
from ..freshness import FreshnessSpec

__all__ = [
    "Backend",
    "Broker",
    "BrokerStats",
    "BucketSpec",
    "DYNAMIC",
    "DeviceCacheConfig",
    "FreshnessSpec",
    "HedgePolicy",
    "PAD_H64",
    "PAD_HI",
    "PAD_KEY",
    "PAD_LO",
    "STDDeviceCache",
    "pack_hashes",
    "pad_batch",
    "splitmix64",
    "state_from_numpy",
    "state_to_numpy",
]
