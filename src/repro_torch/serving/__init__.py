"""Serving runtime of the port: the device-resident STD cache, the broker
(fused and unfused paths, the host engine, live rebalancing, key
invalidation, checkpoints), the sharded cluster (hash and topic routing,
pipelined async dispatch, resilience and recovery, elastic resharding) and
the serving specs."""
from .broker import Backend, Broker, BrokerStats, HedgePolicy
from .cluster import Cluster, ClusterFuture
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
from .resilience import (
    DOWN,
    HEALTHY,
    RECOVERING,
    SUSPECT,
    ResilienceCounters,
    ResilienceSpec,
    ShardHealth,
)
from .spec import BatchPolicySpec, BucketSpec, DispatchSpec, HedgeSpec, ServingSpec
from ..core.spec import PAD_KEY
from ..freshness import FreshnessSpec

__all__ = [
    "Backend",
    "BatchPolicySpec",
    "Broker",
    "BrokerStats",
    "BucketSpec",
    "Cluster",
    "ClusterFuture",
    "DOWN",
    "DYNAMIC",
    "DeviceCacheConfig",
    "DispatchSpec",
    "FreshnessSpec",
    "HEALTHY",
    "HedgePolicy",
    "HedgeSpec",
    "PAD_H64",
    "PAD_HI",
    "PAD_KEY",
    "PAD_LO",
    "PopularityTracker",
    "RECOVERING",
    "RebalanceSpec",
    "ResilienceCounters",
    "ResilienceSpec",
    "STDDeviceCache",
    "SUSPECT",
    "ServingSpec",
    "ShardHealth",
    "pack_hashes",
    "pad_batch",
    "splitmix64",
    "state_from_numpy",
    "state_to_numpy",
    "unpack_state",
]
