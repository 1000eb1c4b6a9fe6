"""Declarative cache configuration: one ``CacheSpec`` for every engine.

A copy of ``repro.core.spec``: ``CacheSpec`` describes the S/T/D layer
structure (paper Sec. 3.2) and compiles to the vectorized engine's
:class:`~repro_torch.core.fast.Layout` (:meth:`CacheSpec.to_layout`) and to
the device cache's ``DeviceCacheConfig`` (:meth:`CacheSpec.to_device`,
with :meth:`CacheSpec.device_static_keys` for the static preload), and
round-trips through JSON that either package reads; it also compiles to the
exact per-request simulator's :class:`~repro_torch.core.policies.CacheUnit`
(:meth:`CacheSpec.to_exact`, with :meth:`AdmissionSpec.to_policy` for the
admission gate), so all three engines evaluate the same cache.

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
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from . import fast
from .alloc import proportional_allocation, uniform_allocation
from .policies import (
    NO_TOPIC,
    AdmissionPolicy,
    CacheUnit,
    LRUCache,
    NullCache,
    PollutingFilter,
    SDCCache,
    STDCache,
    SingletonOracle,
)
from .stats import TrainStats

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

    def to_policy(
        self,
        train_freq: Optional[Mapping] = None,
        n_terms: Optional[Mapping] = None,
        n_chars: Optional[Mapping] = None,
        stream=None,
    ) -> Optional[AdmissionPolicy]:
        """Exact-simulator admission policy (None for admit-all)."""
        if self.kind == "all":
            return None
        if self.kind == "polluting":
            if train_freq is None or n_terms is None or n_chars is None:
                raise ValueError(
                    "polluting admission needs train_freq, n_terms and n_chars "
                    "maps (an empty filter would reject every key)"
                )
            return PollutingFilter(
                train_freq=train_freq,
                n_terms=n_terms,
                n_chars=n_chars,
                min_train_freq=self.min_train_freq,
                max_terms=self.max_terms,
                max_chars=self.max_chars,
            )
        if stream is None:
            raise ValueError("singleton_oracle admission needs the full stream")
        return SingletonOracle.from_stream(stream)

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


def _per_topic(value: Mapping[int, int], topic: np.ndarray) -> np.ndarray:
    """Each key's ``value`` of its topic (0 for a topic without one)."""
    if not value:
        return np.zeros(len(topic), dtype=np.int64)
    ids = np.array(sorted(value), dtype=np.int64)
    vals = np.array([value[t] for t in ids.tolist()], dtype=np.int64)
    j = np.clip(np.searchsorted(ids, topic), 0, len(ids) - 1)
    return np.where(ids[j] == topic, vals[j], 0)


def _count_per_topic(topics: np.ndarray) -> Dict[int, int]:
    return {int(t): int(c) for t, c in zip(*np.unique(topics, return_counts=True))}


# ---------------------------------------------------------------------------
# Exact-engine section helper
# ---------------------------------------------------------------------------


def _topic_section(
    capacity: int,
    topic_queries_by_freq: List,
    f_ts: Optional[float],
    exclude: frozenset = frozenset(),
) -> CacheUnit:
    """One per-topic section: LRU when ``f_ts`` is None, else SDC."""
    if capacity <= 0:
        return NullCache()
    if f_ts is None:
        return LRUCache(capacity)
    n_static = int(round(f_ts * capacity))
    static_keys = []
    for k in topic_queries_by_freq:
        if len(static_keys) >= n_static:
            break
        if k not in exclude:
            static_keys.append(k)
    return SDCCache(static_keys, capacity - len(static_keys))


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

    def to_exact(self, stats: TrainStats) -> CacheUnit:
        """Compile to the exact per-request cache (``repro.core.policies``).

        The exact engine applies admission at replay time, so a spec
        carrying a non-trivial :class:`AdmissionSpec` must be compiled in
        two explicit steps (a silent admit-all would misreport hit rates):
        ``spec.admission.to_policy(...)`` handed to ``simulate`` and
        ``spec.without_admission().to_exact(stats)`` for the structure.
        """
        if not self.admission.trivial:
            raise ValueError(
                "spec carries a non-trivial AdmissionSpec; compile it with "
                "spec.admission.to_policy(...) and pass it to simulate(), "
                "then build the cache with spec.without_admission().to_exact()"
            )
        n_s, n_t, n_d = self.sizes()
        t = self.topic

        if t.include_notopic:
            # every query belongs to a section; no-topic = topic k+1
            extra = (max(stats.topics) + 1) if stats.topics else 0
            distinct = dict(stats.topic_distinct)
            distinct[extra] = len(stats.notopic_by_freq)
            sizes = self._section_sizes(distinct, n_t)
            by_freq = dict(stats.topic_by_freq)
            by_freq[extra] = stats.notopic_by_freq
            static_keys = self._static_train_keys(stats, n_s)
            exclude = (
                frozenset(static_keys) if t.exclude_global_static else frozenset()
            )
            f_ts = t.static_fraction if t.section == "sdc" else None

            def topic_or_extra(key, _topic=stats.topic, _extra=extra):
                tau = _topic(key)
                return tau if tau != NO_TOPIC else _extra

            sections = {
                tau: _topic_section(sizes[tau], by_freq.get(tau, []), f_ts, exclude)
                for tau in sizes
            }
            return STDCache(static_keys, sections, n_d, topic_or_extra)

        if t.fraction == 0:
            # degenerate S+D structure: plain LRU / SDC
            if n_s == 0:
                return LRUCache(n_d)
            return SDCCache(self._static_train_keys(stats, n_s), n_d)

        sizes = self._section_sizes(stats.topic_distinct, n_t)
        static_keys = self._static_train_keys(stats, n_s)
        f_ts = t.static_fraction if t.section == "sdc" else None
        exclude = (
            frozenset(static_keys)
            if (t.section == "sdc" and t.exclude_global_static)
            else frozenset()
        )
        sections = {
            tau: _topic_section(
                sizes[tau], stats.topic_by_freq.get(tau, []), f_ts, exclude
            )
            for tau in sizes
        }
        return STDCache(static_keys, sections, n_d, stats.topic)

    def _static_train_keys(self, stats: TrainStats, n_s: int) -> List:
        ranked = (
            stats.notopic_by_freq if self.static.source == "notopic" else stats.by_freq
        )
        return ranked[:n_s]

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
            m = {
                int(tau): int(round(t.static_fraction * c_t)) if t.section == "sdc" else 0
                for tau, c_t in sizes.items()
            }
            # each section's m most frequent queries are static: the
            # no-topic ones rank among the no-topic keys (section ``extra``)
            notopic = topic == NO_TOPIC
            m_key = np.where(notopic, m[extra], _per_topic(
                {tau: c for tau, c in m.items() if tau != extra}, topic))
            ts = np.where(notopic, stats.notopic_rank, stats.topic_rank) < m_key
            key_part[ts] = fast.ALWAYS_HIT
            n_ts = _count_per_topic(topic[ts & ~notopic])
            n_ts_extra = int((ts & notopic).sum())
            cap: Dict[int, int] = {
                int(tau): c_t - (n_ts_extra if tau == extra else n_ts.get(int(tau), 0))
                for tau, c_t in sizes.items()
            }
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
                m_key = _per_topic(
                    {int(tau): int(round(f_ts * c_t)) for tau, c_t in sizes.items()}, topic
                )
                if t.exclude_global_static:
                    # the m best *non-S* topic queries, by global freq order:
                    # group the eligible keys of the frequency order by topic
                    # (a stable sort keeps the frequency order in each topic)
                    elig = (topic != NO_TOPIC) & ~global_static
                    sel = stats.by_freq[elig[stats.by_freq]]
                    grouped = sel[np.argsort(topic[sel], kind="stable")]
                    t_of = topic[grouped]
                    rank = np.arange(len(grouped)) - np.searchsorted(t_of, t_of, side="left")
                    ts = np.zeros(nq, dtype=bool)
                    ts[grouped[rank < m_key[grouped]]] = True
                else:
                    ts = (topic != NO_TOPIC) & (stats.topic_rank < m_key)
                key_part[ts] = fast.ALWAYS_HIT
                n_ts = _count_per_topic(topic[ts])
                for tau, c_t in sizes.items():
                    cap[int(tau)] = c_t - n_ts.get(int(tau), 0)
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
