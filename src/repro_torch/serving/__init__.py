"""Serving runtime of the port: the device-resident STD cache, the broker
(fused and unfused paths, the host engine, live rebalancing, key
invalidation, checkpoints) and the serving specs.  The sharded cluster is
not ported yet (ROADMAP.md, Queue 1 item 7)."""
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
    unpack_state,
)
from .rebalance import PopularityTracker, RebalanceSpec
from .resilience import ResilienceCounters, ResilienceSpec, ShardHealth
from .spec import BatchPolicySpec, BucketSpec, DispatchSpec, HedgeSpec, ServingSpec
from ..core.spec import PAD_KEY
from ..freshness import FreshnessSpec

__all__ = [
    "Backend",
    "BatchPolicySpec",
    "Broker",
    "BrokerStats",
    "BucketSpec",
    "DYNAMIC",
    "DeviceCacheConfig",
    "DispatchSpec",
    "FreshnessSpec",
    "HedgePolicy",
    "HedgeSpec",
    "PAD_H64",
    "PAD_HI",
    "PAD_KEY",
    "PAD_LO",
    "PopularityTracker",
    "RebalanceSpec",
    "ResilienceCounters",
    "ResilienceSpec",
    "STDDeviceCache",
    "ServingSpec",
    "ShardHealth",
    "pack_hashes",
    "pad_batch",
    "splitmix64",
    "state_from_numpy",
    "state_to_numpy",
    "unpack_state",
]
