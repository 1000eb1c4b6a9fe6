"""Declarative cache configuration: one ``CacheSpec`` for every engine.

A copy of ``repro.core.spec``: ``CacheSpec`` describes the S/T/D layer
structure (paper Sec. 3.2) and compiles to the vectorized engine's
:class:`~repro_torch.core.fast.Layout` (:meth:`CacheSpec.to_layout`) and to
the device cache's ``DeviceCacheConfig`` (:meth:`CacheSpec.to_device`,
with :meth:`CacheSpec.device_static_keys` for the static preload), and
round-trips through JSON that either package reads.  The exact
per-request simulator (``repro.core.policies``) is not ported yet:
:meth:`CacheSpec.to_exact` and :meth:`AdmissionSpec.to_policy` raise
``NotImplementedError`` naming its ``ROADMAP.md`` item.

Layer model (paper Sec. 3.2)::

    +--------------------------------------------------------------+
    | StaticSpec     f_s * N entries, preloaded, read-only          |
    |   source: "global"  -- top training queries overall           |
    |           "notopic" -- top *no-topic* training queries (C1)   |
    +--------------------------------------------------------------+
    | TopicLayerSpec f_t * N entries, split across k sections       |
    |   allocation: "uniform" (STDf) | "proportional" (STDv)        |
    |   section:    "lru" | "sdc" (static_fraction = f_ts)          |
    |   exclude_global_static: skip queries already in S (C2)       |
    |   include_notopic: no-topic queries form section k+1 (Tv)     |
    +--------------------------------------------------------------+
    | DynamicSpec    remaining (1 - f_s - f_t) * N entries, LRU     |
    +--------------------------------------------------------------+
    | AdmissionSpec  gate on misses: "all" | "polluting" | oracle   |
    +--------------------------------------------------------------+
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from ..querylog.synth import NO_TOPIC
from . import fast
from .alloc import proportional_allocation, uniform_allocation


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, Queue 1 item 11)"
    )


SPEC_VERSION = 1

#: The reserved *pad key*: a sentinel query id that is never admitted,
#: never hits, and never displaces a resident entry in any cache engine.
#: The serving tier pads ragged batches up to shape buckets with it
#: (``BucketSpec`` on ``ServingSpec``), so the serving path sees
#: O(#buckets) batch shapes instead of one per distinct batch length.
#: Its 64-bit hash is pinned to all-ones (``repro_torch.serving.
#: device_cache.PAD_H64``); ``splitmix64`` never hashes a real key there (or to 0,
#: the empty-slot sentinel).  Real query ids are always >= 0.
PAD_KEY = -1

#: the paper's experimental grid (Sec. 5), importable for iteration
STRATEGIES = (
    "SDC",
    "STDf_LRU",
    "STDv_LRU",
    "STDv_SDC_C1",
    "STDv_SDC_C2",
    "Tv_SDC",
)

_STATIC_SOURCES = ("global", "notopic")
_ALLOCATIONS = ("proportional", "uniform")
_SECTIONS = ("lru", "sdc")
_DYNAMIC_POLICIES = ("lru", "none")
_ADMISSION_KINDS = ("all", "polluting", "singleton_oracle")


def split_sizes(n: int, f_s: float, f_t: float) -> Tuple[int, int, int]:
    """(|S|, |T|, |D|) with |S| = round(f_s*N), |T| = round(f_t*N), rest D."""
    s = int(round(f_s * n))
    t = int(round(f_t * n))
    s = min(s, n)
    t = min(t, n - s)
    return s, t, n - s - t


# ---------------------------------------------------------------------------
# Spec dataclasses
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StaticSpec:
    """The global static layer S: preloaded top training queries."""

    fraction: float = 0.0  # f_s: share of total entries
    #: which frequency ranking fills S: "global" = top queries overall,
    #: "notopic" = top queries without a topic (paper C1)
    source: str = "global"

    def __post_init__(self):
        object.__setattr__(self, "fraction", float(self.fraction))
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(f"static fraction must be in [0, 1], got {self.fraction}")
        if self.source not in _STATIC_SOURCES:
            raise ValueError(f"static source must be one of {_STATIC_SOURCES}")


@dataclass(frozen=True)
class TopicLayerSpec:
    """The topic layer T: k per-topic sections."""

    fraction: float = 0.0  # f_t: share of total entries
    allocation: str = "proportional"  # "uniform" (STDf) | "proportional" (STDv)
    section: str = "lru"  # per-section policy: "lru" | "sdc"
    #: f_ts: static share of each section (required when section == "sdc")
    static_fraction: Optional[float] = None
    #: C2 semantics: queries already resident in the global S are skipped
    #: when filling per-topic static fractions
    exclude_global_static: bool = False
    #: Tv semantics: no-topic queries form their own section k+1 instead of
    #: falling through to the dynamic cache
    include_notopic: bool = False

    def __post_init__(self):
        object.__setattr__(self, "fraction", float(self.fraction))
        if self.static_fraction is not None:
            object.__setattr__(self, "static_fraction", float(self.static_fraction))
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(f"topic fraction must be in [0, 1], got {self.fraction}")
        if self.allocation not in _ALLOCATIONS:
            raise ValueError(f"allocation must be one of {_ALLOCATIONS}")
        if self.section not in _SECTIONS:
            raise ValueError(f"section must be one of {_SECTIONS}")
        if self.section == "sdc":
            if self.static_fraction is None:
                raise ValueError('section "sdc" requires static_fraction (f_ts)')
            if not 0.0 <= self.static_fraction <= 1.0:
                raise ValueError("static_fraction must be in [0, 1]")


@dataclass(frozen=True)
class DynamicSpec:
    """The dynamic layer D: implied size (1 - f_s - f_t) * N."""

    policy: str = "lru"  # "lru" | "none" (drop the layer even if space remains)

    def __post_init__(self):
        if self.policy not in _DYNAMIC_POLICIES:
            raise ValueError(f"dynamic policy must be one of {_DYNAMIC_POLICIES}")


@dataclass(frozen=True)
class AdmissionSpec:
    """Admission gate applied to misses (paper Sec. 5, RQ4)."""

    kind: str = "all"  # "all" | "polluting" | "singleton_oracle"
    min_train_freq: int = 3  # X (stateful)
    max_terms: int = 5  # Y (stateless)
    max_chars: int = 20  # Z (stateless)

    def __post_init__(self):
        for f in ("min_train_freq", "max_terms", "max_chars"):
            object.__setattr__(self, f, int(getattr(self, f)))
        if self.kind not in _ADMISSION_KINDS:
            raise ValueError(f"admission kind must be one of {_ADMISSION_KINDS}")

    @property
    def trivial(self) -> bool:
        return self.kind == "all"

    # -- compilers ---------------------------------------------------------

    def to_policy(self, *args, **kwargs):
        """Exact-simulator admission policy: the exact simulator
        (``repro.core.policies``) is not ported yet."""
        raise _not_ported("AdmissionSpec.to_policy (the exact simulator's policies)")

    def to_mask(self, log) -> Optional[np.ndarray]:
        """Per-key admitted mask for the vectorized engine (``VecLog`` in)."""
        if self.kind == "all":
            return None
        if self.kind == "polluting":
            train_freq = np.bincount(log.train_keys, minlength=log.n_queries)
            if log.key_terms is None or log.key_chars is None:
                raise ValueError("polluting admission needs key_terms/key_chars")
            return (
                (train_freq >= self.min_train_freq)
                & (log.key_terms < self.max_terms)
                & (log.key_chars < self.max_chars)
            )
        counts = np.bincount(log.keys, minlength=log.n_queries)
        return counts != 1

    def to_serving_gate(self, log=None, admitted=None):
        """Compile the broker/cluster admission gate from the spec.

        Returns ``None`` for admit-all, else a pure callable
        ``query_ids -> bool mask`` (the form the serving tier's fused
        path requires).  The per-key decisions come from
        :meth:`to_mask`: pass the ``VecLog`` via ``log=`` or a
        precompiled ``admitted=`` mask.  This replaces the opaque
        admission callables the broker used to take -- the spec now
        *is* the gate; the callable parameter remains only as a
        compatibility escape hatch.
        """
        if self.trivial:
            return None
        if admitted is None:
            if log is None:
                raise ValueError(
                    "non-trivial AdmissionSpec needs the VecLog (log=) or a "
                    "precompiled admitted= mask to compile a serving gate"
                )
            admitted = self.to_mask(log)
        admitted = np.asarray(admitted, bool)
        n = len(admitted)

        def gate(query_ids: np.ndarray) -> np.ndarray:
            # ids outside the training universe are never admitted (the
            # same judgement the polluting filter passes on unknown keys)
            # rather than crashing or wrapping the mask index
            q = np.asarray(query_ids, np.int64)
            ok = (q >= 0) & (q < n)
            return ok & admitted[np.clip(q, 0, max(n - 1, 0))]

        return gate


# ---------------------------------------------------------------------------
# CacheSpec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CacheSpec:
    """Declarative cache configuration; compile with ``to_exact`` /
    ``to_layout`` / ``to_device``."""

    n_entries: int
    static: StaticSpec = field(default_factory=StaticSpec)
    topic: TopicLayerSpec = field(default_factory=TopicLayerSpec)
    dynamic: DynamicSpec = field(default_factory=DynamicSpec)
    admission: AdmissionSpec = field(default_factory=AdmissionSpec)
    #: display / provenance name ("SDC", "STDv_LRU", ..., or user-defined)
    name: Optional[str] = None

    def __post_init__(self):
        # coerce to a plain int so to_json never chokes on numpy integers
        object.__setattr__(self, "n_entries", int(self.n_entries))
        if self.n_entries < 0:
            raise ValueError(f"n_entries must be >= 0, got {self.n_entries}")

    @property
    def pad_key(self) -> int:
        """The reserved never-resident pad key (see :data:`PAD_KEY`): part
        of every compiled engine's contract, so shape-bucketed serving can
        pad batches without perturbing cache behaviour."""
        return PAD_KEY

    def without_admission(self) -> "CacheSpec":
        """Copy of this spec with the admission gate dropped (admit-all)."""
        return dataclasses.replace(self, admission=AdmissionSpec())

    # -- construction ------------------------------------------------------

    @classmethod
    def from_strategy(
        cls,
        strategy: str,
        n: int,
        f_s: float = 0.0,
        f_t: float = 0.0,
        f_ts: Optional[float] = None,
    ) -> "CacheSpec":
        """The paper's named strategies (plus the LRU baseline).

        ``f_d`` is implied (= 1 - f_s - f_t), matching the paper's tuning.
        """
        f_s = float(f_s)
        f_t = float(f_t)
        f_ts = None if f_ts is None else float(f_ts)
        if strategy == "LRU":
            return cls(n, name="LRU")
        if strategy == "SDC":
            return cls(n, static=StaticSpec(fraction=f_s), name="SDC")
        if strategy == "STDf_LRU":
            return cls(
                n,
                static=StaticSpec(fraction=f_s),
                topic=TopicLayerSpec(fraction=f_t, allocation="uniform"),
                name="STDf_LRU",
            )
        if strategy == "STDv_LRU":
            return cls(
                n,
                static=StaticSpec(fraction=f_s),
                topic=TopicLayerSpec(fraction=f_t, allocation="proportional"),
                name="STDv_LRU",
            )
        if strategy == "STDv_SDC_C1":
            if f_ts is None:
                raise ValueError("STDv_SDC_C1 requires f_ts")
            return cls(
                n,
                static=StaticSpec(fraction=f_s, source="notopic"),
                topic=TopicLayerSpec(
                    fraction=f_t, section="sdc", static_fraction=f_ts
                ),
                name="STDv_SDC_C1",
            )
        if strategy == "STDv_SDC_C2":
            if f_ts is None:
                raise ValueError("STDv_SDC_C2 requires f_ts")
            return cls(
                n,
                static=StaticSpec(fraction=f_s),
                topic=TopicLayerSpec(
                    fraction=f_t,
                    section="sdc",
                    static_fraction=f_ts,
                    exclude_global_static=True,
                ),
                name="STDv_SDC_C2",
            )
        if strategy == "Tv_SDC":
            if f_ts is None:
                raise ValueError("Tv_SDC requires f_ts")
            return cls(
                n,
                topic=TopicLayerSpec(
                    fraction=1.0,
                    section="sdc",
                    static_fraction=f_ts,
                    include_notopic=True,
                ),
                dynamic=DynamicSpec(policy="none"),
                name="Tv_SDC",
            )
        raise ValueError(f"unknown strategy {strategy!r}")

    # -- layer sizing ------------------------------------------------------

    def sizes(self) -> Tuple[int, int, int]:
        """(|S|, |T|, |D|) in entries."""
        n_s, n_t, n_d = split_sizes(
            self.n_entries, self.static.fraction, self.topic.fraction
        )
        if self.dynamic.policy == "none":
            n_d = 0
        return n_s, n_t, n_d

    def _section_sizes(self, distinct: Mapping[int, int], n_t: int) -> Dict[int, int]:
        if self.topic.allocation == "uniform":
            return uniform_allocation(n_t, sorted(distinct))
        return proportional_allocation(n_t, distinct)

    # -- serialization -----------------------------------------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["version"] = SPEC_VERSION
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "CacheSpec":
        d = json.loads(s)
        version = d.pop("version", SPEC_VERSION)
        if version > SPEC_VERSION:
            raise ValueError(f"CacheSpec version {version} is newer than {SPEC_VERSION}")
        return cls(
            n_entries=d["n_entries"],
            static=StaticSpec(**d["static"]),
            topic=TopicLayerSpec(**d["topic"]),
            dynamic=DynamicSpec(**d["dynamic"]),
            admission=AdmissionSpec(**d["admission"]),
            name=d.get("name"),
        )

    # -- exact engine ------------------------------------------------------

    def to_exact(self, stats=None):
        """Compile to the exact per-request cache: the exact simulator
        (``repro.core.policies``) is not ported yet."""
        raise _not_ported("CacheSpec.to_exact (the exact simulator)")

    # -- vectorized engine -------------------------------------------------

    def to_layout(self, stats, admitted: Optional[np.ndarray] = None, log=None):
        """Compile to a reuse-distance ``Layout`` (``repro_torch.core.fast``).

        ``stats`` is a :class:`repro_torch.core.fast.VecStats`; ``admitted`` an
        optional per-key admission mask (rejected keys become ``NO_CACHE``).
        When the spec carries a non-trivial :class:`AdmissionSpec` the mask
        is compiled from it automatically — pass ``log`` (the ``VecLog``,
        needed for train frequencies / query features) or a precompiled
        ``admitted`` mask; compiling such a spec without either raises
        rather than silently evaluating admit-all.
        """
        if admitted is None and not self.admission.trivial:
            if log is None:
                raise ValueError(
                    "spec carries a non-trivial AdmissionSpec; pass the "
                    "VecLog via log= (mask compiled automatically) or a "
                    "precompiled admitted= mask"
                )
            admitted = self.admission.to_mask(log)

        nq = len(stats.train_freq)
        topic = stats.key_topic
        n_s, n_t, n_d = self.sizes()
        t = self.topic
        seen = stats.train_freq > 0

        if self.static.source == "notopic":
            global_static = stats.notopic_rank < n_s
        else:
            global_static = (stats.freq_rank < n_s) & seen

        if t.include_notopic:
            extra = (max(stats.topic_distinct) + 1) if stats.topic_distinct else 0
            distinct = dict(stats.topic_distinct)
            distinct[extra] = int(((topic == NO_TOPIC) & seen).sum())
            sizes = self._section_sizes(distinct, n_t)
            key_part = np.where(topic == NO_TOPIC, extra, topic).astype(np.int64)
            cap: Dict[int, int] = {}
            for tau, c_t in sizes.items():
                tau = int(tau)
                m = (
                    int(round(t.static_fraction * c_t))
                    if t.section == "sdc"
                    else 0
                )
                if tau == extra:
                    ts = (topic == NO_TOPIC) & (stats.notopic_rank < m)
                else:
                    ts = (topic == tau) & (stats.topic_rank < m)
                key_part[ts] = fast.ALWAYS_HIT
                cap[tau] = c_t - int(ts.sum())
            key_part[global_static] = fast.ALWAYS_HIT
            if n_d > 0:
                cap[fast.DYNAMIC_PART] = n_d
        elif t.fraction == 0:
            key_part = np.full(nq, fast.DYNAMIC_PART, dtype=np.int64)
            key_part[global_static] = fast.ALWAYS_HIT
            cap = {fast.DYNAMIC_PART: n_d}
        else:
            key_part = np.where(topic == NO_TOPIC, fast.DYNAMIC_PART, topic).astype(
                np.int64
            )
            sizes = self._section_sizes(stats.topic_distinct, n_t)
            cap = {}
            if t.section == "sdc":
                f_ts = t.static_fraction
                for tau, c_t in sizes.items():
                    tau = int(tau)
                    m = int(round(f_ts * c_t))
                    mask_t = topic == tau
                    if t.exclude_global_static:
                        # the m best *non-S* topic queries, by global freq order
                        elig = mask_t & ~global_static
                        order = stats.by_freq[elig[stats.by_freq]]
                        ts_keys = order[:m]
                    else:
                        ts_keys = np.flatnonzero(mask_t & (stats.topic_rank < m))
                    topic_static = np.zeros(nq, dtype=bool)
                    topic_static[ts_keys] = True
                    key_part[mask_t & topic_static] = fast.ALWAYS_HIT
                    cap[tau] = c_t - len(ts_keys)
            else:
                cap = {int(tau): int(c) for tau, c in sizes.items()}
            cap[fast.DYNAMIC_PART] = n_d
            key_part[global_static] = fast.ALWAYS_HIT
            # topics whose *whole* section (static fraction included) got
            # zero entries are "not handled" (paper Alg. 1): their queries
            # fall through to the dynamic cache, so f_t = 0 degenerates
            # exactly to SDC.  Sections with a static fraction but 0 LRU
            # entries keep their routing (their LRU part just never hits).
            empty = [int(tau) for tau, c_t in sizes.items() if c_t == 0]
            if empty:
                key_part[np.isin(key_part, empty)] = fast.DYNAMIC_PART

        if admitted is not None:
            key_part[(key_part != fast.ALWAYS_HIT) & ~admitted] = fast.NO_CACHE
        return fast.Layout(key_part=key_part, capacity=cap)

    # -- device engine -----------------------------------------------------

    def to_device(
        self,
        topic_distinct: Mapping[int, int],
        ways: int = 8,
        value_dim: int = 8,
        popularity: Optional[Mapping[int, float]] = None,
    ):
        """Compile to a ``DeviceCacheConfig`` (``repro_torch.serving.device_cache``).

        Per-topic static fractions (SDC sections) map to the device's single
        global static array: their budget moves from the section's LRU ways
        into ``static_entries`` (preload the keys with
        :meth:`device_static_keys`).  ``include_notopic`` sections map to the
        dynamic partition, which is where the device routes no-topic queries.

        ``popularity`` overrides the *training* distinct counts with live
        popularity estimates for the proportional sizing only -- the topic
        universe stays ``topic_distinct``'s (topics missing from
        ``popularity`` weigh 0).  It is the spec-level twin of
        :meth:`DeviceCacheConfig.rebalanced` (conformance-tested equal for
        proportional specs): use it to compile a cache directly to a
        drift-tracked allocation; the live serving path
        (``RebalanceSpec``) rebalances the already-compiled config
        instead.  The declared layer structure never changes either way.
        """
        # deferred: the serving package imports this module
        from ..serving.device_cache import DeviceCacheConfig

        n_s, n_t, n_d = self.sizes()
        t = self.topic
        distinct = dict(topic_distinct)
        extra = None
        if t.include_notopic:
            extra = (max(distinct) + 1) if distinct else 0
            # sizing needs a popularity estimate for the no-topic section;
            # callers pass it under the `extra` id or we fall back to the
            # mean section popularity
            if extra not in distinct:
                distinct[extra] = (
                    int(np.mean(list(distinct.values()))) if distinct else 0
                )
        if t.allocation == "uniform":
            sizes = uniform_allocation(n_t, sorted(distinct))
        else:
            if popularity is not None:
                weights = {
                    int(tau): float(popularity.get(int(tau), 0.0)) for tau in distinct
                }
                if extra is not None and extra not in popularity:
                    # mirror the default path's mean-popularity fallback for
                    # the synthetic no-topic section (its traffic is rarely
                    # in a caller's per-topic estimate)
                    weights[extra] = (
                        float(np.mean(list(popularity.values()))) if popularity else 0.0
                    )
            else:
                weights = distinct
            sizes = proportional_allocation(n_t, weights, exact=True)
        static_extra = 0
        if t.section == "sdc":
            f_ts = t.static_fraction
            shaved = {}
            for tau, c_t in sizes.items():
                m = int(round(f_ts * c_t))
                shaved[tau] = c_t - m
                static_extra += m
            sizes = shaved
        if extra is not None:
            n_d += sizes.pop(extra, 0)
        return DeviceCacheConfig(
            total_entries=self.n_entries,
            ways=ways,
            value_dim=value_dim,
            topic_entries={int(tau): int(c) for tau, c in sizes.items()},
            dynamic_entries=n_d,
            static_entries=n_s + static_extra,
        )

    def device_static_keys(self, stats) -> np.ndarray:
        """Key ids to preload into the device static array: exactly the
        always-hit set of the vectorized layout (global static + per-topic
        static fractions), so the three engines agree on layer membership."""
        # static membership is independent of admission (the gate only
        # affects what may enter the LRU partitions on a miss)
        layout = self.without_admission().to_layout(stats)
        return np.flatnonzero(layout.key_part == fast.ALWAYS_HIT).astype(np.int64)


__all__ = [
    "PAD_KEY",
    "SPEC_VERSION",
    "STRATEGIES",
    "AdmissionSpec",
    "CacheSpec",
    "DynamicSpec",
    "StaticSpec",
    "TopicLayerSpec",
    "split_sizes",
]
