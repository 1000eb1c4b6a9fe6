"""Declarative serving configuration: one ``ServingSpec``, one broker or
one sharded cluster.

A copy of ``repro.serving.spec``.  :class:`repro_torch.core.spec.CacheSpec`
makes the *cache* declarative; this module does the same for the serving
tier in front of it.  A ``ServingSpec`` embeds the cache spec and adds
everything the broker constructor takes as loose keyword arguments --
engine selection, fused serving, micro-batching, coalescing, hedging,
rebalancing, bucketing, freshness -- plus the two deployment axes of a
sharded cluster: ``shards`` and ``routing`` (``"hash"``: splitmix64's high
word; ``"topic"``: topic tau -> shard tau mod N, no-topic queries by
hash).

The spec compiles to one broker with
:meth:`repro_torch.serving.broker.Broker.from_spec` (``shards`` is ignored
there) or to a sharded cluster with
:meth:`repro_torch.serving.cluster.Cluster.from_spec`, whose shard layouts
come from the shard helpers (:meth:`ServingSpec.shard_of`,
:meth:`ServingSpec.device_configs`, ...), so the JSON and the shard layouts
of both packages agree.

``use_kernel`` is kept so that JSON written by either package loads in the
other to an equal spec.  It changes nothing in the port: on the card the
kernels always run, and on the CPU their plain versions.

Like ``CacheSpec`` it is JSON round-trippable (:meth:`ServingSpec.to_json`
/ :meth:`ServingSpec.from_json`), so checkpoint manifests can embed the
deployment they were produced under.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple

import numpy as np

from ..core.spec import CacheSpec
from ..freshness import FreshnessSpec
from .device_cache import DeviceCacheConfig, splitmix64
from .rebalance import RebalanceSpec
from .resilience import ResilienceSpec

SERVING_SPEC_VERSION = 1

_ROUTINGS = ("hash", "topic")
_ENGINES = ("auto", "host", "device")
_BUCKET_MODES = ("none", "pow2", "explicit")


def _split_entries(total: int, shards: int, i: int) -> int:
    """Shard i's share of ``total`` entries (as even as possible)."""
    return total // shards + (1 if i < total % shards else 0)


@dataclass(frozen=True)
class BucketSpec:
    """Shape buckets for data-dependent batch lengths -- the static-shape
    serving contract.

    A ``BucketSpec`` rounds every batch length up to a *bucket* and pads
    the tail with the reserved never-resident pad key
    (:data:`repro_torch.core.spec.PAD_KEY`), so the serving path sees
    O(#buckets) batch shapes, not one per distinct length, and padded
    serving stays
    request-for-request identical to unpadded serving on the real
    requests (the pad key never hits, is never admitted, and never
    displaces a resident entry -- property-tested in every engine).

    ``mode``     -- ``"pow2"`` (next power of two >= the batch length),
                    ``"explicit"`` (smallest declared size that fits;
                    larger batches fall back to powers of two so the
                    compile count stays bounded), or ``"none"``
                    (explicitly disable padding; a broker given no
                    ``BucketSpec`` buckets in pow2).
    ``sizes``    -- the explicit bucket sizes (ascending), required for
                    ``mode="explicit"``.
    ``min_size`` -- the smallest bucket (pow2 mode); tiny trailing
                    batches all land in one bucket.
    """

    mode: str = "pow2"  # "none" | "pow2" | "explicit"
    sizes: Tuple[int, ...] = ()
    min_size: int = 8

    def __post_init__(self):
        object.__setattr__(self, "min_size", int(self.min_size))
        object.__setattr__(
            self, "sizes", tuple(sorted(int(s) for s in self.sizes))
        )
        if self.mode not in _BUCKET_MODES:
            raise ValueError(f"bucket mode must be one of {_BUCKET_MODES}, got {self.mode!r}")
        if self.min_size < 1:
            raise ValueError(f"bucket min_size must be >= 1, got {self.min_size}")
        if self.mode == "explicit" and not self.sizes:
            raise ValueError('bucket mode "explicit" requires sizes')
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"bucket sizes must be >= 1, got {self.sizes}")

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    def padded_len(self, b: int) -> int:
        """The bucket a batch of ``b`` requests pads up to (``b`` itself
        when disabled or empty)."""
        if b <= 0 or not self.enabled:
            return max(int(b), 0)
        if self.mode == "explicit":
            for s in self.sizes:
                if s >= b:
                    return s
            # beyond the largest declared bucket: powers of two keep the
            # compile count logarithmic instead of one trace per length
        return 1 << (max(int(b), self.min_size) - 1).bit_length()


_OVERFLOWS = ("shed", "defer")


@dataclass(frozen=True)
class BatchPolicySpec:
    """Deadline-driven batch coalescing -- the compiled form of the
    ``ServingSpec.microbatch`` / ``coalesce`` knobs.

    The open-loop load harness (:mod:`repro_torch.loadgen.harness`) forms
    batches from an arrival stream under this policy; the broker's bare knobs
    compile to its defaults via
    :meth:`ServingSpec.compiled_batch_policy`, so the batching a
    deployment serves under is one declarative object, not scattered
    integers.

    ``max_batch``    -- close a batch as soon as this many requests are
                        pending and the (model) server is free.
    ``deadline_us``  -- the oldest pending request never waits longer
                        than this (virtual time) for its batch to close:
                        a deadline flush takes everything pending.
    ``max_queue``    -- bounded pending queue (per tenant).  An arrival
                        past the bound is dropped (``overflow="shed"``)
                        or admitted-but-counted (``overflow="defer"``,
                        pure backpressure accounting).
    ``snap_to_bucket`` -- abundance-closed batches snap *down* to the
                        serving tier's :class:`BucketSpec` boundary, so
                        a formed batch is exactly a compiled shape and
                        the pad overhead of the static-shape contract
                        goes to zero on the saturated path.
    ``coalesce``     -- mirror of the broker's in-batch duplicate-miss
                        coalescing knob (the broker enforces it; the
                        policy records it so one object describes the
                        whole batching behaviour).
    ``service_base_us`` / ``service_per_request_us`` -- the deterministic
                        *provisioned* service model the virtual clock
                        advances by: serving a (padded) batch of ``b``
                        occupies the model server for ``base + per*b``
                        microseconds.  Queueing decisions (batch
                        formation, shed set) depend only on this model
                        and the seeded arrivals -- never on measured
                        wall time -- which is what makes the harness
                        deterministic.  Measured wall-clock service time
                        enters reported latency, not decisions.
    """

    max_batch: int = 256
    deadline_us: float = 2_000.0
    max_queue: int = 8192
    overflow: str = "shed"  # "shed" | "defer"
    snap_to_bucket: bool = True
    coalesce: bool = True
    service_base_us: float = 300.0
    service_per_request_us: float = 2.0

    def __post_init__(self):
        object.__setattr__(self, "max_batch", int(self.max_batch))
        object.__setattr__(self, "max_queue", int(self.max_queue))
        for f in ("deadline_us", "service_base_us", "service_per_request_us"):
            object.__setattr__(self, f, float(getattr(self, f)))
        for f in ("snap_to_bucket", "coalesce"):
            object.__setattr__(self, f, bool(getattr(self, f)))
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.deadline_us <= 0:
            raise ValueError(f"deadline_us must be > 0, got {self.deadline_us}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.overflow not in _OVERFLOWS:
            raise ValueError(
                f"overflow must be one of {_OVERFLOWS}, got {self.overflow!r}"
            )
        if self.service_base_us < 0 or self.service_per_request_us < 0:
            raise ValueError("service model costs must be >= 0")

    def service_cost_s(self, batch: int) -> float:
        """Model service time (seconds) for a padded batch of ``batch``."""
        return (self.service_base_us + self.service_per_request_us * batch) * 1e-6

    def capacity_rps(self, batch: Optional[int] = None) -> float:
        """Provisioned throughput (requests/s) at full batches of
        ``batch`` (default ``max_batch``) -- the natural unit for offered
        arrival rates in a load sweep."""
        b = self.max_batch if batch is None else int(batch)
        cost = self.service_cost_s(b)
        return b / cost if cost > 0 else float("inf")


@dataclass(frozen=True)
class DispatchSpec:
    """Pipelined async cluster dispatch -- the front-end knobs.

    With a ``DispatchSpec`` on the serving spec, :class:`Cluster` exposes
    ``serve_async``: batches are *enqueued* onto per-shard work queues
    and served lazily when a result is demanded (or the queue bound
    forces a drain), letting consecutive batches' shard slices **fuse**
    into one broker call per shard.  Fusion amortizes the fixed
    per-call cost (padding, freshness arrays, dispatch overhead, the
    double-buffered fill) across batches -- which is what makes a
    sharded cluster on a small host *faster* than one broker, not just
    not-slower.

    Fused serving is always *value*-identical to serving the batches
    back-to-back, and bit-deterministic (the same stream replays the
    same episode).  A duplicate-free fused group is also
    *state*-identical: the commit engines replay in arrival order
    either way.  A key repeated **across** fused batches collapses to
    one served request (cache and backend see it once, at its last
    occurrence -- where sequential serving's final recency refresh
    would land), so with cross-batch duplicates the hit mask and the
    skipped occurrences' transient recency are approximate: a key first
    seen in batch A and repeated in batch B counts as a miss in both
    when fused, where sequential serving would count B's a hit.  The
    conformance-pinned paths therefore never fuse implicitly:
    ``Cluster.serve`` drains its batch immediately, and
    ``dispatch=None`` (the default) keeps the cluster synchronous and
    request-for-request identical to the pre-async front end.

    ``pipeline``      -- enable cross-batch fusion on the async path
                         (``False``: serve_async still works but every
                         queued batch is served unfused, in order).
    ``max_fuse``      -- at most this many queued batches fuse into one
                         shard call.
    ``fuse_requests`` -- stop fusing once a call holds this many
                         requests (the engines' per-call sweet spot; on
                         the host engine ~2k requests amortizes the
                         fixed cost without outgrowing it).
    ``max_queue``     -- per-shard queue bound; ``serve_async`` drains
                         synchronously past it (backpressure, so an
                         abandoned future can never pin unbounded work).
    """

    pipeline: bool = True
    max_fuse: int = 8
    fuse_requests: int = 2048
    max_queue: int = 32

    def __post_init__(self):
        object.__setattr__(self, "pipeline", bool(self.pipeline))
        for f in ("max_fuse", "fuse_requests", "max_queue"):
            object.__setattr__(self, f, int(getattr(self, f)))
        if self.max_fuse < 1:
            raise ValueError(f"max_fuse must be >= 1, got {self.max_fuse}")
        if self.fuse_requests < 1:
            raise ValueError(
                f"fuse_requests must be >= 1, got {self.fuse_requests}"
            )
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")


@dataclass(frozen=True)
class HedgeSpec:
    """Declarative straggler mitigation (serializable analogue of
    :class:`repro_torch.serving.broker.HedgePolicy`)."""

    deadline_s: float = 0.5
    max_hedges: int = 1

    def __post_init__(self):
        object.__setattr__(self, "deadline_s", float(self.deadline_s))
        object.__setattr__(self, "max_hedges", int(self.max_hedges))
        if self.deadline_s <= 0:
            raise ValueError(f"hedge deadline_s must be > 0, got {self.deadline_s}")
        if self.max_hedges < 1:
            raise ValueError(f"max_hedges must be >= 1, got {self.max_hedges}")

    def to_policy(self):
        """Compile to the broker's runtime ``HedgePolicy``."""
        from .broker import HedgePolicy  # deferred: broker imports this module

        return HedgePolicy(deadline_s=self.deadline_s, max_hedges=self.max_hedges)


@dataclass(frozen=True)
class ServingSpec:
    """One declarative description of a (possibly sharded) serving tier."""

    cache: CacheSpec
    shards: int = 1
    routing: str = "hash"  # "hash" | "topic"
    engine: str = "auto"  # "auto" | "host" | "device"
    fused: bool = True
    #: kept for JSON parity with the reference; the port's kernels always
    #: run on the card and their plain versions on the CPU
    use_kernel: bool = False
    microbatch: int = 256
    coalesce: bool = True
    value_dim: int = 8
    ways: int = 8
    hedge: Optional[HedgeSpec] = None
    #: drift-aware topic rebalancing (None = the paper's frozen allocation)
    rebalance: Optional[RebalanceSpec] = None
    #: shape-bucketed batch padding (static-shape serving contract).
    #: None = auto: brokers on the device engine bucket with pow2
    #: defaults, the host engine serves unpadded (numpy gains nothing
    #: from fixed shapes).  Set explicitly -- including ``BucketSpec(mode="none")``
    #: -- to override the auto choice on every shard.
    bucket: Optional[BucketSpec] = None
    #: deadline-driven batch coalescing for open-loop serving.  None =
    #: compile the ``microbatch``/``coalesce`` knobs into a default
    #: policy (:meth:`compiled_batch_policy`); set explicitly to control
    #: deadlines, queue bounds and the provisioned service model.
    batch_policy: Optional[BatchPolicySpec] = None
    #: fault handling for sharded dispatch: timeout/retry/backoff, the
    #: per-shard health state machine, and degraded miss-through.  None =
    #: any shard failure propagates to the caller.
    resilience: Optional[ResilienceSpec] = None
    #: freshness policy: default + per-topic TTLs, stale-hit handling,
    #: epoch granularity.  None = entries never
    #: expire (the pre-freshness behaviour, bit-exact on every engine).
    freshness: Optional[FreshnessSpec] = None
    #: pipelined async cluster dispatch (per-shard work queues +
    #: cross-batch fusion).  None = the synchronous
    #: scatter-gather front end, request-for-request identical to the
    #: pre-async behaviour.
    dispatch: Optional[DispatchSpec] = None
    #: one-dispatch device serving: deferred fill + probe + commit +
    #: value gather through one entry point (one serve-kernel call on
    #: the card), so a served batch costs exactly one device call.  False
    #: keeps the legacy fused pair (request-for-request identical).  Only
    #: meaningful on the device engine with ``fused``.
    fused_one_call: bool = True
    #: warm every bucket shape at broker construction (and after every
    #: rebalance rebind): the kernels build and each entry point makes
    #: one launch per shape.  Off by default.
    aot_warmup: bool = False

    def __post_init__(self):
        for f in ("shards", "microbatch", "value_dim", "ways"):
            object.__setattr__(self, f, int(getattr(self, f)))
        for f in ("fused", "use_kernel", "coalesce", "fused_one_call", "aot_warmup"):
            object.__setattr__(self, f, bool(getattr(self, f)))
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.routing not in _ROUTINGS:
            raise ValueError(f"routing must be one of {_ROUTINGS}, got {self.routing!r}")
        if self.engine not in _ENGINES:
            raise ValueError(f"engine must be one of {_ENGINES}, got {self.engine!r}")
        if self.microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {self.microbatch}")
        if self.value_dim < 1 or self.ways < 1:
            raise ValueError("value_dim and ways must be >= 1")

    # -- serialization -----------------------------------------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        # delegate the cache layer to CacheSpec's own (versioned) round-trip
        d["cache"] = json.loads(self.cache.to_json())
        d["version"] = SERVING_SPEC_VERSION
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ServingSpec":
        d = json.loads(s)
        version = d.pop("version", SERVING_SPEC_VERSION)
        if version > SERVING_SPEC_VERSION:
            raise ValueError(
                f"ServingSpec version {version} is newer than {SERVING_SPEC_VERSION}"
            )
        hedge = d.pop("hedge", None)
        rebalance = d.pop("rebalance", None)
        bucket = d.pop("bucket", None)
        policy = d.pop("batch_policy", None)
        resilience = d.pop("resilience", None)
        freshness = d.pop("freshness", None)
        dispatch = d.pop("dispatch", None)
        return cls(
            cache=CacheSpec.from_json(json.dumps(d.pop("cache"))),
            hedge=HedgeSpec(**hedge) if hedge is not None else None,
            rebalance=RebalanceSpec(**rebalance) if rebalance is not None else None,
            bucket=BucketSpec(**bucket) if bucket is not None else None,
            batch_policy=BatchPolicySpec(**policy) if policy is not None else None,
            resilience=(
                ResilienceSpec(**resilience) if resilience is not None else None
            ),
            freshness=(
                FreshnessSpec.from_dict(freshness) if freshness is not None else None
            ),
            dispatch=DispatchSpec(**dispatch) if dispatch is not None else None,
            **d,
        )

    # -- batching policy ---------------------------------------------------

    def compiled_batch_policy(self) -> BatchPolicySpec:
        """The batch coalescing policy this deployment serves under.

        An explicit ``batch_policy`` wins wholesale; otherwise the bare
        ``microbatch``/``coalesce`` knobs compile to a
        :class:`BatchPolicySpec` with ``max_batch=microbatch`` -- the
        knobs are defaults for the policy, not a separate mechanism.
        """
        if self.batch_policy is not None:
            return self.batch_policy
        return BatchPolicySpec(max_batch=self.microbatch, coalesce=self.coalesce)

    def effective_bucket(self) -> BucketSpec:
        """The bucket the batching policy snaps to: the explicit
        ``bucket`` when set, else the device-engine auto default (pow2).
        The planner needs a concrete bucket even for host-engine
        deployments (which serve unpadded): snapping still shapes formed
        batches, it just costs nothing there."""
        return self.bucket if self.bucket is not None else BucketSpec()

    # -- routing -----------------------------------------------------------

    def shard_of(
        self, query_ids: np.ndarray, topics: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Shard index for every query (host-side, deterministic).

        ``topics`` is required for ``routing="topic"``: queries with a
        topic go to shard ``topic mod shards``; no-topic queries (< 0)
        fall back to hash routing so they spread over every shard's
        dynamic partition.
        """
        query_ids = np.asarray(query_ids)
        if self.shards == 1:
            return np.zeros(len(query_ids), np.int32)
        return self.shard_of_hashes(splitmix64(query_ids), topics=topics)

    def shard_of_hashes(
        self, h64: np.ndarray, topics: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """:meth:`shard_of` over pre-computed splitmix64 hashes.

        The cluster front end hashes every batch exactly once (routing
        here, set indexing inside the shard broker via the same words),
        and elastic resharding re-routes resident entries from their
        *stored* hash words without needing the original query ids.
        """
        h64 = np.asarray(h64, np.uint64)
        if self.shards == 1:
            return np.zeros(len(h64), np.int32)
        # route on the *high* hash word: the cache's set index consumes
        # the low word (h_lo % n_sets), so routing on the same bits would
        # leave each shard only 1/gcd(shards, n_sets) of its sets
        # reachable (e.g. half of every LRU partition dead at shards=2)
        by_hash = ((h64 >> np.uint64(32)) % np.uint64(self.shards)).astype(np.int32)
        if self.routing == "hash":
            return by_hash
        if topics is None:
            raise ValueError('routing="topic" needs the per-query topics')
        topics = np.asarray(topics, np.int64)
        return np.where(topics >= 0, topics % self.shards, by_hash).astype(np.int32)

    # -- shard compilation -------------------------------------------------

    def shard_cache_spec(self, i: int) -> CacheSpec:
        """Shard i's cache spec under hash routing: the same layer
        structure at 1/N of every layer's entries."""
        if not 0 <= i < self.shards:
            raise ValueError(f"shard index {i} out of range for {self.shards} shards")
        return dataclasses.replace(
            self.cache, n_entries=_split_entries(self.cache.n_entries, self.shards, i)
        )

    def device_configs(
        self, topic_distinct: Mapping[int, int]
    ) -> List[DeviceCacheConfig]:
        """Every shard's device config (the full compilation runs once)."""
        if self.routing == "topic" and self.shards > 1:
            full = self.cache.to_device(
                topic_distinct, ways=self.ways, value_dim=self.value_dim
            )
            return [self._slice_topic_config(full, i) for i in range(self.shards)]
        return [
            self.shard_device_config(i, topic_distinct) for i in range(self.shards)
        ]

    def shard_device_config(
        self, i: int, topic_distinct: Mapping[int, int]
    ) -> DeviceCacheConfig:
        """Compile shard i's slice of the cache to a device config."""
        if not 0 <= i < self.shards:
            raise ValueError(f"shard index {i} out of range for {self.shards} shards")
        if self.shards == 1:
            return self.cache.to_device(
                topic_distinct, ways=self.ways, value_dim=self.value_dim
            )
        if self.routing == "hash":
            return self.shard_cache_spec(i).to_device(
                topic_distinct, ways=self.ways, value_dim=self.value_dim
            )
        full = self.cache.to_device(
            topic_distinct, ways=self.ways, value_dim=self.value_dim
        )
        return self._slice_topic_config(full, i)

    def _slice_topic_config(
        self, full: DeviceCacheConfig, i: int
    ) -> DeviceCacheConfig:
        # topic routing: whole partitions move, the dynamic/static layers
        # split evenly (their traffic is hash-routed)
        topic_entries = {
            int(t): int(c)
            for t, c in full.topic_entries.items()
            if int(t) % self.shards == i
        }
        dyn = _split_entries(full.dynamic_entries, self.shards, i)
        static = _split_entries(full.static_entries, self.shards, i)
        return DeviceCacheConfig(
            total_entries=static + sum(topic_entries.values()) + dyn,
            ways=full.ways,
            value_dim=full.value_dim,
            topic_entries=topic_entries,
            dynamic_entries=dyn,
            static_entries=static,
        )


__all__ = [
    "SERVING_SPEC_VERSION",
    "BatchPolicySpec",
    "BucketSpec",
    "DispatchSpec",
    "FreshnessSpec",
    "HedgeSpec",
    "RebalanceSpec",
    "ResilienceSpec",
    "ServingSpec",
]
