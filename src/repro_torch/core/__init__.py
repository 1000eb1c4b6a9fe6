"""Core caching library of the port: the paper's STD cache and its baselines.

Exact per-request policies (``policies``), the strategies' cache
constructors (``build``), Bélády's optimal bound (``belady``) and the sequential
simulation (``simulate``), all host Python as in ``repro.core``; the
reuse-distance engine (``fast`` / ``rd_offline`` / ``torch_sim``), which
evaluates every strategy and every cache size from one pass over the
stream, runs on the card unless the caller passes ``device="cpu"``.  The
same names as ``repro.core``, plus ``PAD_KEY``, ``resolve_device`` and
``allocation_divergence``.
"""
from .alloc import allocation_divergence, proportional_allocation, uniform_allocation
from .belady import belady_hit_rate, belady_hits, next_use_array
from .build import STRATEGIES, build_lru, build_sdc, build_std, split_sizes
from .device import resolve_device
from .fast import (
    ALWAYS_HIT,
    DYNAMIC_PART,
    NO_CACHE,
    Layout,
    TraceAnalysis,
    VecLog,
    VecStats,
    analyze,
    hit_rate,
    lru_hits_all_sizes,
    make_layout,
)
from .policies import (
    NO_TOPIC,
    AdmissionPolicy,
    AdmitAll,
    CacheUnit,
    LRUCache,
    NullCache,
    PollutingFilter,
    SDCCache,
    STDCache,
    SingletonOracle,
    StaticCache,
)
from .simulate import SimResult, simulate
from .spec import (
    PAD_KEY,
    AdmissionSpec,
    CacheSpec,
    DynamicSpec,
    StaticSpec,
    TopicLayerSpec,
)
from .stats import TrainStats

__all__ = [
    "ALWAYS_HIT",
    "AdmissionPolicy",
    "AdmissionSpec",
    "AdmitAll",
    "CacheSpec",
    "CacheUnit",
    "DYNAMIC_PART",
    "DynamicSpec",
    "Layout",
    "LRUCache",
    "NO_CACHE",
    "NO_TOPIC",
    "NullCache",
    "PAD_KEY",
    "PollutingFilter",
    "SDCCache",
    "STDCache",
    "STRATEGIES",
    "SimResult",
    "SingletonOracle",
    "StaticCache",
    "StaticSpec",
    "TopicLayerSpec",
    "TraceAnalysis",
    "TrainStats",
    "VecLog",
    "VecStats",
    "allocation_divergence",
    "analyze",
    "belady_hit_rate",
    "belady_hits",
    "build_lru",
    "build_sdc",
    "build_std",
    "hit_rate",
    "lru_hits_all_sizes",
    "make_layout",
    "next_use_array",
    "proportional_allocation",
    "resolve_device",
    "simulate",
    "split_sizes",
    "uniform_allocation",
]
