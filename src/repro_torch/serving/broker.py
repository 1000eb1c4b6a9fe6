"""Front-end broker (paper Fig. 2) on PyTorch: cache -> backend -> reply.

Port of ``repro.serving.broker``.  Per batch:

1. hash + topic-route every query on the host, and pad the batch up to
   its shape bucket with the reserved never-resident pad key;
2. one fused serve call.  On the default path (``fused_one_call``) the
   previous batch's deferred value fill, the probe, the commit and the
   probed value-row gather are one call of the serve kernel
   (``STDDeviceCache.serve_one_call``), counted per call in
   ``Broker.dispatch_counts``.  ``fused_one_call=False`` keeps the legacy
   pair of entry points (``fused`` / ``fused_fill``), which run the
   probe/commit kernel;
3. misses go to a backend in micro-batches with hedged requests;
4. backend results are scattered into the slots the fused call reserved
   (deferred value fill), riding inside the next batch's call.  ``flush()``
   applies a pending fill on demand; checkpoints, rebalances and key
   invalidations flush first.

``fused=False`` is the three-call path (probe, miss commit, hit-refresh
commit) through ``STDDeviceCache.commit_vectorized``, whose commits run the
probe/commit kernel on the card.  ``engine="host"`` serves on the numpy
host engine (a broker and cache on the CPU); ``engine="auto"`` (default)
and ``"device"`` serve through the kernels on the broker's device, their
plain versions on the CPU.

A ``RebalanceSpec`` adds the drift rebalancer: a popularity tracker
observes every served batch's topics, and ``rebalance()`` re-splits the
topic layer by the tracked popularity and migrates the resident entries
(``STDDeviceCache.repartition``; on the card one ``probe_and_commit``
launch).  ``save``/``restore`` checkpoint the state, the stats, the
freshness clock, the spec and the live allocation in the reference's
format (``repro_torch.train.checkpoint``), so either package restores the
other's checkpoints.

There is no jit: ``trace_counts`` stays empty.  ``warmup`` builds the
kernels and makes one warm launch of every serving entry per bucket shape.
The resilience counters stay 0 on a broker: the sharded cluster
(:class:`repro_torch.serving.cluster.Cluster`) counts them cluster-side.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.alloc import allocation_divergence
from ..core.spec import CacheSpec
from ..freshness import FreshnessRuntime, FreshnessSpec
from ..train import checkpoint as ckpt_lib
from .device_cache import (
    PAD_H64,
    DeviceCacheConfig,
    STDDeviceCache,
    pack_hashes,
    pad_batch,
    resolve_device,
    splitmix64,
    state_from_numpy,
    state_to_numpy,
    to_device_words,
)
from .rebalance import PopularityTracker, RebalanceSpec
from .spec import BucketSpec


@dataclasses.dataclass
class BrokerStats:
    requests: int = 0
    hits: int = 0
    static_hits: int = 0
    topic_hits: int = 0
    backend_calls: int = 0
    hedged_calls: int = 0
    admitted: int = 0
    #: duplicate in-batch misses answered from a single backend call
    coalesced: int = 0
    #: pad requests appended by shape bucketing (never counted in
    #: ``requests``; pad overhead = padded / (requests + padded))
    padded: int = 0
    #: non-empty batches served (the rebalance trigger's cadence clock)
    batches: int = 0
    #: live repartitions applied by the drift rebalancer
    rebalances: int = 0
    #: resident entries carried into new layouts, summed over rebalances
    migrated: int = 0
    #: cluster resilience counters (kept for the checkpoint format; the
    #: cluster counts them on its side, so a broker's stay 0)
    degraded: int = 0
    retried: int = 0
    failed_over: int = 0
    timeouts: int = 0
    #: topic-layer hits whose entry had outlived its TTL (or fell under
    #: an invalidation floor) at probe time, both stale policies
    expired: int = 0
    #: expired hits answered from the cached value anyway
    #: (``stale_policy="serve_stale_while_revalidate"``)
    stale_served: int = 0
    #: backend refreshes triggered by stale serves (after coalescing)
    revalidations: int = 0
    #: stale values served *without* a revalidation in flight -- must
    #: stay 0; a nonzero count means the freshness contract broke
    freshness_violations: int = 0
    #: invalidation events applied (slots zeroed for key events, one per
    #: topic/flush event for epoch-bump invalidations)
    invalidations: int = 0
    #: the online popularity tracker's state: exponentially-decayed served
    #: request counts per tracked topic (sorted id order) + a trailing
    #: no-topic bucket; shares memory with ``Broker.tracker`` and is None
    #: without a ``RebalanceSpec``
    topic_counts: Optional[np.ndarray] = None

    @property
    def hit_rate(self) -> float:
        return self.hits / self.requests if self.requests else 0.0


Backend = Callable[[np.ndarray], np.ndarray]  # query ids -> values (B, V)


@dataclasses.dataclass
class HedgePolicy:
    """Straggler mitigation: re-dispatch a micro-batch that exceeds
    ``deadline_s`` to the next executor; first completed result wins."""

    deadline_s: float = 0.5
    max_hedges: int = 1


class Broker:
    def __init__(
        self,
        cache: STDDeviceCache,
        backends: Sequence[Backend],
        topic_of: Callable[[np.ndarray], np.ndarray],
        admission: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        hedge: Optional[HedgePolicy] = None,
        microbatch: int = 256,
        coalesce: bool = True,
        spec: Optional[CacheSpec] = None,
        fused: bool = True,
        engine: str = "auto",
        rebalance: Optional[RebalanceSpec] = None,
        bucket: Optional[BucketSpec] = None,
        defer_fill: Optional[bool] = None,
        freshness: Optional[FreshnessSpec] = None,
        fused_one_call: bool = True,
        aot_warmup: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if cache.device != self.device:
            raise ValueError(
                f"cache lives on {cache.device} but the broker was asked to "
                f"serve on {self.device}"
            )
        if engine == "auto":
            # the port's choice: the kernels on the broker's device (their
            # plain versions on the CPU); the numpy engine only when asked
            engine = "device"
        if engine not in ("host", "device"):
            raise ValueError(f"engine must be auto|host|device, got {engine!r}")
        if engine == "host" and self.device.type != "cpu":
            raise ValueError(
                'engine="host" serves with numpy on the host: build the cache '
                'and the broker with device="cpu"'
            )
        self.engine = engine
        #: declarative configuration this cache was compiled from (embedded
        #: in checkpoints so a restored broker can verify it serves the
        #: same cache)
        self.spec = spec
        if spec is not None and not spec.admission.trivial and admission is None:
            raise ValueError(
                "spec carries a non-trivial AdmissionSpec but no admission "
                "callable was provided; the broker would silently admit "
                "everything the spec says to filter"
            )
        self.cache = cache
        # the kernels update ks and value in place, so the broker owns its
        # copy of the mutable words; the static layer is read-only and shared
        self.state = self._own_state(cache.init_state)
        self.backends = list(backends)
        self.topic_of = topic_of
        self.admission = admission
        self.hedge = hedge
        self.microbatch = microbatch
        #: in-flight request coalescing: duplicate keys inside one batch
        #: are dispatched to the backend only once
        self.coalesce = coalesce
        #: serve through the fused probe-and-commit path; False is the
        #: three-call path (probe, miss commit, hit-refresh commit)
        self.fused = fused
        #: whether warmup() runs at every cache (re)bind -- construction
        #: and rebalance
        self.aot_warmup = bool(aot_warmup)
        #: static-shape contract: pad batches up to shape buckets with the
        #: reserved pad key.  Auto (bucket=None): the device engine buckets
        #: (pow2), the host engine serves unpadded.
        if bucket is None:
            bucket = BucketSpec() if engine == "device" else BucketSpec(mode="none")
        self.bucket: Optional[BucketSpec] = bucket if bucket.enabled else None
        #: double-buffer the deferred value fill into the next fused call
        #: (device engine only; the host engine's in-place numpy fill is
        #: already a single cheap scatter)
        if defer_fill is None:
            defer_fill = engine == "device" and fused
        self.defer_fill = bool(defer_fill) and engine == "device" and fused
        #: one-dispatch serving: the deferred fill, probe, commit and value
        #: gather share one entry point (one serve-kernel call per batch).
        #: False keeps the legacy ``fused``/``fused_fill`` pair.
        self.fused_one_call = bool(fused_one_call) and engine == "device" and fused
        #: compressed pending fill plan: (set_idx, way, values) of the last
        #: batch's inserts, applied inside the next fused call or by flush()
        self._pending_fill: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        #: guards the pending-fill handoff (the plan lands exactly once);
        #: reentrant because _serve_fused calls flush() under the lock
        self._fill_lock = threading.RLock()
        #: no jit in the port: nothing is ever traced
        self.trace_counts: Dict[str, int] = {}
        #: calls per serving entry point (warm-up calls included)
        self.dispatch_counts: Dict[str, int] = {}
        self._warmed_shapes: set = set()
        #: rebalance cooldown/hysteresis runtime state (not checkpointed:
        #: a restored broker re-arms conservatively from scratch)
        self._last_rebalance_batch: Optional[int] = None
        self._rebalance_cooling = False
        self.stats = BrokerStats()
        #: drift-aware rebalancing: the tracker observes every served
        #: batch's topics; every ``rebalance.every`` batches the tracked
        #: popularity is recompiled into a fresh proportional allocation
        #: and resident entries migrate through ``STDDeviceCache.repartition``
        self.rebalance_spec = rebalance
        self.tracker: Optional[PopularityTracker] = None
        if rebalance is not None:
            self.tracker = rebalance.to_tracker(cache.topic_ids)
            self.stats.topic_counts = self.tracker.counts
        #: freshness clock (TTL expiry + invalidation floors); None = entries
        #: never expire and every call carries zero epochs/floors
        self.freshness_spec = freshness
        self.freshness: Optional[FreshnessRuntime] = (
            FreshnessRuntime(freshness, cache.topic_ids)
            if freshness is not None
            else None
        )
        self._bind_cache(cache)
        self._pool = ThreadPoolExecutor(max_workers=max(2, len(backends)))
        self._closed = False

    @staticmethod
    def _own_state(state) -> Dict[str, torch.Tensor]:
        """A state whose mutable words (``ks``, ``value``, ``clock``) this
        broker owns; the read-only static layer is shared."""
        return {k: v.clone() if k in ("ks", "value", "clock") else v for k, v in state.items()}

    @classmethod
    def from_spec(
        cls,
        spec,
        stats,
        backends: Sequence[Backend],
        topic_of: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        value_fn=None,
        log=None,
        admitted: Optional[np.ndarray] = None,
        admission: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        cache: Optional[STDDeviceCache] = None,
        device="cuda",
    ) -> "Broker":
        """Compile a :class:`repro_torch.serving.spec.ServingSpec` to one
        broker on ``device``.

        The cache is built from ``spec.cache`` (static layer preloaded via
        ``value_fn``), the admission gate is compiled from the spec's
        ``AdmissionSpec`` (``log``/``admitted`` feed it; the ``admission``
        callable remains as an escape hatch), and every serving knob --
        engine, fused, microbatch, coalescing, hedging, rebalancing,
        bucketing, freshness -- comes from the spec.  ``spec.shards`` is
        ignored here (``Cluster.from_spec`` builds one broker per shard,
        each through this method with its slice's ``cache``), and
        ``spec.use_kernel`` changes nothing: the kernels always run on the
        card.
        """
        if cache is None:
            cache = STDDeviceCache.from_spec(
                spec.cache, stats, value_fn=value_fn, ways=spec.ways,
                value_dim=spec.value_dim, device=device,
            )
        if admission is None:
            admission = spec.cache.admission.to_serving_gate(log=log, admitted=admitted)
        if topic_of is None:
            key_topic = np.asarray(stats.key_topic)
            topic_of = lambda q: key_topic[np.asarray(q, np.int64)]  # noqa: E731
        return cls(
            cache,
            backends,
            topic_of=topic_of,
            admission=admission,
            hedge=spec.hedge.to_policy() if spec.hedge is not None else None,
            microbatch=spec.microbatch,
            coalesce=spec.coalesce,
            spec=spec.cache,
            fused=spec.fused,
            engine=spec.engine,
            rebalance=spec.rebalance,
            bucket=spec.bucket,
            freshness=spec.freshness,
            fused_one_call=spec.fused_one_call,
            aot_warmup=spec.aot_warmup,
            device=device,
        )

    def _counted(self, name: str, fn):
        """Wrap an entry point so every call bumps ``dispatch_counts[name]``."""
        counts = self.dispatch_counts

        def wrapper(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)

        return wrapper

    def _bind_cache(self, cache: STDDeviceCache) -> None:
        """Bind the serving entry points to ``cache`` -- at construction
        and after every rebalance or restore swaps the cache layout -- and
        warm them up when ``aot_warmup``."""
        self.cache = cache
        self._probe = self._counted("probe", cache.probe)
        self._commit = self._counted("commit", cache.commit_vectorized)
        self._fused_step = self._counted("fused", cache.probe_and_commit)
        self._fused_fill_step = self._counted("fused_fill", cache.fill_probe_and_commit)
        self._one_call_step = self._counted("one_call", cache.serve_one_call)
        self._fill = self._counted("fill", cache.fill_values)
        self._warmed_shapes = set()
        if self.aot_warmup:
            self.warmup()

    def warmup_shapes(self, sizes: Sequence[int] = ()) -> List[int]:
        """The batch shapes the serving path can present: every bucket
        boundary from ``padded_len(1)`` up to the microbatch's bucket, plus
        any explicit ``sizes`` (bucket-snapped)."""
        snap = (
            (lambda s: self.bucket.padded_len(s))
            if self.bucket is not None
            else (lambda s: int(s))
        )
        shapes = {snap(int(s)) for s in sizes if int(s) > 0}
        if self.bucket is not None:
            top = self.bucket.padded_len(self.microbatch)
            s = self.bucket.padded_len(1)
            while s <= top:
                shapes.add(s)
                s = self.bucket.padded_len(s + 1)
            shapes.add(top)
        elif not shapes:
            shapes.add(int(self.microbatch))
        return sorted(shapes)

    def _requests(self, h_hi, h_lo, parts, admit, eps, min_ep):
        """Host request arrays -> the device tensors the entry points take."""
        dev = self.device
        return (
            to_device_words(h_hi, dev),
            to_device_words(h_lo, dev),
            torch.from_numpy(np.asarray(parts, np.int32)).to(dev),
            torch.from_numpy(np.asarray(admit, bool)).to(dev),
            to_device_words(eps, dev),
            to_device_words(min_ep, dev),
        )

    def warmup(self, sizes: Sequence[int] = ()) -> List[int]:
        """Build the kernels and make one warm call of every serving entry
        point at every bucket shape, on all-pad batches: pads are inert,
        the outputs are discarded, and state, stats and the pending fill
        are untouched.  Idempotent per bound cache.  Returns the shapes
        warmed by this call; the host engine builds nothing and returns
        ``[]``."""
        if self.engine == "host":
            return []
        warmed = []
        for s in self.warmup_shapes(sizes):
            if s in self._warmed_shapes:
                continue
            h_hi, h_lo = pack_hashes(np.full(s, PAD_H64, np.uint64))
            zeros = np.zeros(s, np.uint32)
            args = self._requests(
                h_hi, h_lo, np.full(s, self.cache.k, np.int32), np.zeros(s, bool),
                zeros, zeros,
            )
            if self.fused and self.fused_one_call:
                self._one_call_step(self.state, *self._pad_plan(None, s), *args)
            elif self.fused:
                self._fused_step(self.state, *args)
                self._fused_fill_step(self.state, *self._pad_plan(None, s), *args)
            else:
                self._probe(self.state, *args[:3], args[5])
                vals = torch.zeros((s, self.cache.cfg.value_dim), dtype=torch.int32,
                                   device=self.device)
                self._commit(self.state, *args[:3], vals, *args[3:])
            # flush() pads a pending plan to its own bucket, so the
            # standalone fill sees the same shape ladder
            self._fill(self.state, *self._pad_plan(None, s))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._warmed_shapes.add(s)
            warmed.append(s)
        return warmed

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Apply any pending value fill and shut down the hedging executor.
        Idempotent; ``serve`` after close raises ``RuntimeError``."""
        if self._closed:
            return
        self.flush()
        self._pool.shutdown(wait=True)
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "Broker":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- serving -------------------------------------------------------------

    def advance_time(self, t_s: float) -> None:
        """Advance the freshness clock to virtual time ``t_s`` (seconds).
        No-op without a :class:`FreshnessSpec`."""
        if self.freshness is not None:
            self.freshness.advance(t_s)

    def _freshness_arrays(self, parts: np.ndarray):
        """Per-request (min_epoch, epochs) uint32 arrays for a (padded)
        batch; zeros without a freshness spec."""
        if self.freshness is None:
            z = np.zeros(len(parts), np.uint32)
            return z, z
        return self.freshness.min_epoch(parts), self.freshness.epochs(len(parts))

    def serve(
        self,
        query_ids: np.ndarray,
        topics: Optional[np.ndarray] = None,
        h64: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Serve one batch of query ids -> (values (B, V), hit mask).

        ``topics`` / ``h64`` short-circuit ``topic_of`` / ``splitmix64``
        when the caller already has them.  Probes are atomic per batch: a
        duplicate key inside one batch is probed before its first
        occurrence commits, so it counts as a miss.  The admission policy
        runs before the probe, over the whole batch.  The batch is padded
        up to its shape bucket with the reserved pad key; pads never hit,
        never write, never reach the backend, and are sliced off.
        """
        if self._closed:
            raise RuntimeError(
                "Broker.serve called after close(); build a new broker to "
                "keep serving"
            )
        if topics is None:
            topics = self.topic_of(query_ids)
        parts = np.asarray(self.cache.parts_for(np.asarray(topics)), np.int32)
        if h64 is None:
            h64 = splitmix64(query_ids)
        h_hi, h_lo = pack_hashes(h64)
        h_hi, h_lo, parts = self._pad_to_bucket(h_hi, h_lo, parts)
        min_ep, eps = self._freshness_arrays(parts)
        serve = self._serve_fused if self.fused else self._serve_unfused
        out = serve(query_ids, parts, h_hi, h_lo, min_ep, eps)
        self._after_batch(topics)
        return out

    def _serve_unfused(
        self, query_ids, parts, h_hi, h_lo, min_ep, eps
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The three-call path: probe, then commit the misses, then the
        hit refreshes (each commit one ``probe_and_commit`` launch on the
        card)."""
        b = len(query_ids)
        dev = self.device
        hit, layer, value, stale = (
            t.cpu().numpy() for t in self._probe(
                self.state, to_device_words(h_hi, dev), to_device_words(h_lo, dev),
                torch.from_numpy(parts).to(dev), to_device_words(min_ep, dev),
            )
        )
        hit, layer, stale = hit[:b], layer[:b], stale[:b]
        values = np.array(value[:b])  # writable copy, pads sliced off
        self.stats.expired += int(stale.sum())
        swr = (
            self.freshness_spec is not None
            and self.freshness_spec.stale_policy == "serve_stale_while_revalidate"
        )
        if not swr:
            # policy "miss": an expired hit re-fetches before answering
            hit = hit & ~stale
            # tripwire: stale serves under policy "miss" are violations,
            # structurally zero
            self.stats.freshness_violations += int((hit & stale).sum())
        miss_idx = np.flatnonzero(~hit)
        if len(miss_idx):
            if self.coalesce:
                uniq, inverse = np.unique(query_ids[miss_idx], return_inverse=True)
                self.stats.coalesced += len(miss_idx) - len(uniq)
                miss_values = self._dispatch(uniq)[inverse]
            else:
                miss_values = self._dispatch(query_ids[miss_idx])
            values[miss_idx] = miss_values
            admit = (
                np.asarray(self.admission(query_ids[miss_idx]), bool)
                if self.admission is not None
                else np.ones(len(miss_idx), bool)
            )
            # expired entries refresh regardless of admission (they are
            # resident); only true misses consult the gate
            self.stats.admitted += int((admit & ~stale[miss_idx]).sum())
            self._commit_bucketed(
                h_hi[miss_idx], h_lo[miss_idx], parts[miss_idx], miss_values, admit,
                epochs=eps[miss_idx], min_epoch=min_ep[miss_idx],
            )
        # hits refresh recency too (exact LRU semantics); a stale
        # serve-while-revalidate hit carries its backend refresh value into
        # the same commit (the engines only write values where the entry
        # is stale)
        hit_idx = np.flatnonzero(hit & (layer == 1))
        if len(hit_idx):
            commit_vals = values[hit_idx]
            if swr:
                reval = np.flatnonzero(stale[hit_idx])
                if len(reval):
                    self.stats.stale_served += len(reval)
                    uniq, inverse = np.unique(query_ids[hit_idx][reval], return_inverse=True)
                    self.stats.revalidations += len(uniq)
                    commit_vals = commit_vals.copy()
                    commit_vals[reval] = self._dispatch(uniq)[inverse]
            self._commit_bucketed(
                h_hi[hit_idx], h_lo[hit_idx], parts[hit_idx], commit_vals,
                np.zeros(len(hit_idx), bool),  # refresh only, never insert
                epochs=eps[hit_idx], min_epoch=min_ep[hit_idx],
            )
        self.stats.requests += b
        self.stats.hits += int(hit.sum())
        self.stats.static_hits += int(((layer == 0) & hit).sum())
        self.stats.topic_hits += int(((layer == 1) & hit).sum())
        return values, hit

    def _pad_to_bucket(self, h_hi, h_lo, parts):
        """Pad the request arrays up to the batch's shape bucket with the
        reserved pad key (routed at the dynamic partition)."""
        b = len(h_hi)
        bp = self.bucket.padded_len(b) if self.bucket is not None else b
        self.stats.padded += max(bp - b, 0)
        h_hi, h_lo, parts, _, _ = pad_batch(h_hi, h_lo, parts, self.cache.k, bp)
        return h_hi, h_lo, parts

    def _commit_bucketed(
        self, h_hi, h_lo, parts, values, admit, epochs=None, min_epoch=None
    ) -> None:
        """Unfused-path commit over a data-dependent subset (misses or hit
        refreshes), padded up to its bucket."""
        n = len(h_hi)
        bp = self.bucket.padded_len(n) if self.bucket is not None else n
        self.stats.padded += max(bp - n, 0)
        h_hi, h_lo, parts, values, admit = pad_batch(
            h_hi, h_lo, parts, self.cache.k, bp, values=values, admit=admit
        )
        eps = np.zeros(bp, np.uint32)
        minep = np.zeros(bp, np.uint32)
        if epochs is not None:
            eps[:n] = epochs
        if min_epoch is not None:
            minep[:n] = min_epoch
        dev = self.device
        self.state = self._commit(
            self.state, to_device_words(h_hi, dev), to_device_words(h_lo, dev),
            torch.from_numpy(parts).to(dev), torch.from_numpy(values).to(dev),
            torch.from_numpy(admit).to(dev), to_device_words(eps, dev),
            to_device_words(minep, dev),
        )

    def _after_batch(self, topics: np.ndarray) -> None:
        """Post-serve bookkeeping: advance the batch clock, feed the drift
        tracker, and run a scheduled rebalance check at the spec cadence.
        Rebalancing happens strictly *between* batches."""
        if len(topics) == 0:
            return
        self.stats.batches += 1
        if self.tracker is None:
            return
        self.tracker.observe(np.asarray(topics))
        every = self.rebalance_spec.every
        if every and self.stats.batches % every == 0:
            self.rebalance()

    def _serve_fused(
        self, query_ids, parts, h_hi, h_lo, min_ep, eps
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One fused device call per batch; the request arrays may carry a
        bucket-padded tail of pad keys, sliced off the outputs here.
        ``min_ep``/``eps`` are the batch's freshness floors and write
        epochs (zeros without a spec)."""
        b = len(query_ids)
        bp = len(h_hi)
        admit = (
            np.asarray(self.admission(query_ids), bool)
            if self.admission is not None
            else np.ones(b, bool)
        )
        if bp > b:  # pads are never admitted (the kernels also mask them)
            admit = np.concatenate([admit, np.zeros(bp - b, bool)])
        if self.engine == "host":
            # the broker owns its state: the previous batch's words are
            # updated in place
            hit, layer, values, stale, self.state, (set_idx, wrote_np, way) = (
                self.cache.probe_and_commit_host(
                    self.state, h_hi, h_lo, parts, admit,
                    epochs=eps, min_epoch=min_ep, inplace=True,
                )
            )
            hit, layer, stale = hit[:b], layer[:b], stale[:b]
        else:
            hit, layer, values, stale, set_idx, wrote_np, way, plan_t = self._serve_device(
                b, bp, h_hi, h_lo, parts, admit, eps, min_ep)
        self.stats.expired += int(stale.sum())
        swr = (
            self.freshness_spec is not None
            and self.freshness_spec.stale_policy == "serve_stale_while_revalidate"
        )
        if not swr:
            # policy "miss": an expired hit re-fetches before answering;
            # the kernel already reserved its slot for the refresh
            hit = hit & ~stale
            # tripwire: stale serves under policy "miss" are violations,
            # structurally zero
            self.stats.freshness_violations += int((hit & stale).sum())
        miss_idx = np.flatnonzero(~hit)
        if len(miss_idx):
            if self.coalesce:
                uniq, inverse = np.unique(query_ids[miss_idx], return_inverse=True)
                self.stats.coalesced += len(miss_idx) - len(uniq)
                values[miss_idx] = self._dispatch(uniq)[inverse]
            else:
                values[miss_idx] = self._dispatch(query_ids[miss_idx])
            # expired entries refresh regardless of admission (they are
            # resident); only true misses consult the gate
            self.stats.admitted += int((admit[miss_idx] & ~stale[miss_idx]).sum())
        # serve-stale-while-revalidate: answer stale hits from the cached
        # value now, fetch the fresh one too, and route it into the
        # reserved slot via the deferred fill
        fill_vals = values
        if swr:
            reval_idx = np.flatnonzero(hit & stale)
            if len(reval_idx):
                self.stats.stale_served += len(reval_idx)
                uniq, inverse = np.unique(query_ids[reval_idx], return_inverse=True)
                self.stats.revalidations += len(uniq)
                fill_vals = values.copy()
                fill_vals[reval_idx] = self._dispatch(uniq)[inverse]
        # deferred fill: scatter results into the slots the fused call
        # reserved (inserts and stale revalidations write)
        if wrote_np.any():
            if self.engine == "host":
                self.state = self.cache.fill_values_host(
                    self.state, set_idx, wrote_np, way, fill_vals, inplace=True
                )
            elif self.defer_fill:
                # double-buffer: the plan lands inside the next fused call
                # (or flush()); the next probe reads values post-fill
                sel = np.flatnonzero(wrote_np)
                with self._fill_lock:
                    self._pending_fill = (set_idx[sel], way[sel], fill_vals[sel])
            else:
                self.state = self._fill(
                    self.state, *plan_t,
                    torch.from_numpy(np.ascontiguousarray(fill_vals)).to(self.device),
                )
        self.stats.requests += b
        self.stats.hits += int(hit.sum())
        self.stats.static_hits += int(((layer == 0) & hit).sum())
        self.stats.topic_hits += int(((layer == 1) & hit).sum())
        return values[:b], hit

    def _serve_device(self, b, bp, h_hi, h_lo, parts, admit, eps, min_ep):
        """The device engine's fused call; returns the host arrays ``(hit,
        layer, values, stale, set_idx, wrote, way)`` and the device plan."""
        req = self._requests(h_hi, h_lo, parts, admit, eps, min_ep)
        with self._fill_lock:
            pending = self._pending_fill
            if self.fused_one_call:
                # one-dispatch serve: fill + probe + commit + value gather
                # in one serve-kernel call; an empty plan rides the same
                # entry point
                if pending is not None and len(pending[0]) > bp:
                    self.flush()  # plan larger than this bucket (rare)
                    pending = None
                out = self._one_call_step(self.state, *self._pad_plan(pending, bp), *req)
            elif pending is not None and 0 < len(pending[0]) <= bp:
                # double-buffered fill: the previous batch's value scatter
                # lands first, then this batch's probe/commit
                out = self._fused_fill_step(self.state, *self._pad_plan(pending, bp), *req)
            else:
                self.flush()  # plan larger than this bucket: standalone fill
                out = self._fused_step(self.state, *req)
            # consumed only once the call was issued against it
            self._pending_fill = None
            hit_t, layer_t, value_t, stale_t, self.state, plan_t = out
        # one device -> host copy for everything the host needs
        cols = [value_t] + [
            t.to(torch.int32)[:, None]
            for t in (hit_t, layer_t, stale_t, *plan_t)
        ]
        host = torch.cat(cols, 1).cpu().numpy()
        v = value_t.shape[1]
        values = host[:, :v].copy()  # (bp, V) writable; sliced on return
        hit = host[:b, v] != 0
        layer = host[:b, v + 1]
        stale = host[:b, v + 2] != 0
        set_idx, wrote_np, way = host[:, v + 3], host[:, v + 4] != 0, host[:, v + 5]
        return hit, layer, values, stale, set_idx, wrote_np, way, plan_t

    def _pad_plan(self, pending, bp: int):
        """Pad a compressed pending-fill plan up to ``bp`` entries (pads
        carry ``wrote=False``) as device tensors in
        :meth:`STDDeviceCache.fill_values` argument order.
        ``pending=None`` builds the all-inert plan."""
        if pending is None:
            f_set = np.zeros(0, np.int32)
            f_way = np.zeros(0, np.int32)
            f_vals = np.zeros((0, self.cache.cfg.value_dim), np.int32)
        else:
            f_set, f_way, f_vals = pending
        n = len(f_set)
        set_p = np.zeros(bp, np.int32)
        set_p[:n] = f_set
        way_p = np.zeros(bp, np.int32)
        way_p[:n] = f_way
        wrote_p = np.zeros(bp, bool)
        wrote_p[:n] = True
        vals_p = np.zeros((bp, f_vals.shape[1]), np.int32)
        vals_p[:n] = f_vals
        dev = self.device
        return tuple(torch.from_numpy(x).to(dev) for x in (set_p, wrote_p, way_p, vals_p))

    def flush(self) -> None:
        """Apply a double-buffered pending value fill to the state now.
        Idempotent, and safe to overlap with a fused serve."""
        with self._fill_lock:
            pending = self._pending_fill
            if pending is None:
                return
            n = len(pending[0])
            bp = self.bucket.padded_len(n) if self.bucket is not None else n
            self.state = self._fill(self.state, *self._pad_plan(pending, bp))
            # consumed only after the fill was issued: a raise above keeps
            # the plan pending
            self._pending_fill = None

    # -- invalidation --------------------------------------------------------

    def invalidate(
        self,
        keys: Optional[np.ndarray] = None,
        topic: Optional[int] = None,
    ) -> int:
        """Invalidate cached results: by key, by topic, or everything.

        Exactly one of ``keys``/``topic`` must be given.  ``keys`` zeroes
        the matching resident slots (control-plane traffic; returns the
        number of slots dropped).  ``topic`` is O(1): the topic's partition
        floor jumps above the current epoch and every resident entry of the
        partition expires at once -- no cache words move, the next probes
        simply see them stale.  ``topic=-1`` flushes every partition.
        Topic invalidation needs a :class:`FreshnessSpec`; key invalidation
        works on any broker.
        """
        if (keys is None) == (topic is None):
            raise ValueError("invalidate() takes exactly one of keys= or topic=")
        if topic is not None:
            if self.freshness is None:
                raise ValueError(
                    "topic invalidation uses epoch floors and needs a "
                    "FreshnessSpec; pass keys= for slot-zeroing invalidation "
                    "or build the broker with freshness configured"
                )
            if int(topic) < 0:
                self.freshness.flush_all()
            else:
                part = int(self.cache.parts_for(np.asarray([int(topic)]))[0])
                self.freshness.flush_topic(part)
            self.stats.invalidations += 1
            return 0
        keys = np.asarray(keys)
        if len(keys) == 0:
            return 0
        self.flush()  # pending values must land before slots are dropped
        h_hi, h_lo = pack_hashes(splitmix64(keys))
        parts = np.asarray(self.cache.parts_for(np.asarray(self.topic_of(keys))))
        self.state, n = self.cache.invalidate_keys(self.state, h_hi, h_lo, parts)
        self.stats.invalidations += n
        return n

    def _dispatch(self, miss_ids: np.ndarray) -> np.ndarray:
        """Micro-batched backend dispatch with hedging."""
        out = []
        for lo in range(0, len(miss_ids), self.microbatch):
            chunk = miss_ids[lo : lo + self.microbatch]
            out.append(self._call_hedged(chunk))
        return np.concatenate(out, axis=0)

    def _call_hedged(self, chunk: np.ndarray) -> np.ndarray:
        self.stats.backend_calls += 1
        if self.hedge is None or len(self.backends) == 1:
            return self.backends[0](chunk)
        fut = self._pool.submit(self.backends[0], chunk)
        done, _ = wait([fut], timeout=self.hedge.deadline_s, return_when=FIRST_COMPLETED)
        if done:
            return fut.result()
        # straggler: hedge to backups, first result wins
        futs = [fut]
        for backup in self.backends[1 : 1 + self.hedge.max_hedges]:
            self.stats.hedged_calls += 1
            futs.append(self._pool.submit(backup, chunk))
        while True:
            done, pending = wait(futs, return_when=FIRST_COMPLETED)
            for f in done:
                if f.exception() is None:
                    return f.result()
                futs = list(pending)
            if not futs:
                raise RuntimeError("all backends failed")

    # -- drift-aware rebalancing ----------------------------------------------

    def rebalance(self, force: bool = False) -> bool:
        """Recompute the topic allocation from tracked popularity and
        migrate resident entries into the new layout (live, between
        batches).

        Returns True when a migration ran.  Skips (returning False) when
        the tracker has no signal yet (``min_count``), when the target
        integer allocation equals the current one (the cache state stays
        bit-identical), or, unless ``force``, when the spec's cooldown
        (``min_interval`` batches since the last migration) or its
        (hysteresis-widened) divergence ``threshold`` gates the check.
        After a migration the effective threshold is ``threshold +
        hysteresis`` until a scheduled check observes the divergence
        settled back at or below ``threshold``.  On the device engine the
        migration is one ``probe_and_commit`` launch (``repartition`` with
        ``engine="vec"``); on the host engine the numpy replay.
        """
        if self.tracker is None:
            raise ValueError(
                "broker was built without a RebalanceSpec; there is no "
                "popularity tracker to rebalance from"
            )
        sp = self.rebalance_spec
        if self.tracker.topic_mass < max(sp.min_count, 1e-9):
            return False  # no signal yet: keep the current allocation
        if (
            not force
            and sp.min_interval > 0
            and self._last_rebalance_batch is not None
            and self.stats.batches - self._last_rebalance_batch < sp.min_interval
        ):
            return False  # cooldown: too soon after the last migration
        pop = self.tracker.popularity()
        new_cfg = self.cache.cfg.rebalanced(pop)
        current = {int(t): int(c) for t, c in self.cache.cfg.topic_entries.items()}
        div = allocation_divergence(current, pop)
        # the settle check runs before the no-op return: popularity settling
        # back to exactly the live allocation must still re-arm the band
        if div <= sp.threshold:
            self._rebalance_cooling = False  # signal settled: re-arm
        if new_cfg == self.cache.cfg:
            return False
        if not force:
            eff = sp.threshold + (sp.hysteresis if self._rebalance_cooling else 0.0)
            if eff > 0.0 and div < eff:
                return False
        self.flush()  # a pending value fill must land before migration
        new_cache, new_state = self.cache.repartition(
            self.state, new_cfg,
            engine="host" if self.engine == "host" else "vec",
            bucket=self.bucket,
        )
        self.state = new_state
        self._bind_cache(new_cache)
        self.stats.rebalances += 1
        w = new_cfg.ways
        self.stats.migrated += int((new_state["ks"][:, :w] != 0).sum())
        self._last_rebalance_batch = self.stats.batches
        self._rebalance_cooling = sp.hysteresis > 0.0
        return True

    # -- fault tolerance -------------------------------------------------------

    def _stats_tree(self) -> Dict[str, np.ndarray]:
        """Checkpointable stats leaves (None fields -- an absent tracker --
        are dropped; npz cannot hold them and there is nothing to save)."""
        return {
            k: np.asarray(v)
            for k, v in dataclasses.asdict(self.stats).items()
            if v is not None
        }

    def save(self, ckpt_dir: str, step: int) -> str:
        """Checkpoint the cache state, the stats, the freshness clock, the
        spec and the live allocation as step ``step`` of ``ckpt_dir``, in
        the reference's format and dtypes (``ks`` as uint32 words)."""
        self.flush()  # a pending value fill is part of the state
        tree = {"cache": state_to_numpy(self.state), "stats": self._stats_tree()}
        if self.freshness is not None:
            # the clock and invalidation floors are state: entries must not
            # un-expire across a restart
            tree["freshness"] = self.freshness.tree()
        if self.spec is not None:
            tree["spec_json"] = np.frombuffer(
                self.spec.to_json().encode("utf-8"), dtype=np.uint8
            )
        # the *live* allocation: a rebalanced broker's layout differs from
        # the spec's initial compile, and a restore must not revert it
        tree["alloc_json"] = np.frombuffer(
            self.cache.cfg.to_json().encode("utf-8"), dtype=np.uint8
        )
        return ckpt_lib.save(ckpt_dir, step, tree)

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Adopt checkpoint ``step`` (the latest when None) of ``ckpt_dir``:
        the state onto this broker's device, the stats, the tracker, the
        freshness clock and the checkpoint's live allocation.  The spec and
        the allocation are checked before any array loads; a failed
        restore leaves the broker as it was.  Returns the step."""
        # a pending fill targets the pre-restore state's slots: drop it,
        # and re-arm the rebalance cooldown from scratch
        self._pending_fill = None
        self._last_rebalance_batch = None
        self._rebalance_cooling = False
        if step is None:
            step = ckpt_lib.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        if self.spec is not None:
            raw = ckpt_lib.load_leaf(ckpt_dir, step, "spec_json")
            if raw is not None:
                saved = CacheSpec.from_json(bytes(np.asarray(raw)).decode("utf-8"))
                if saved != self.spec:
                    raise ValueError(
                        "checkpoint was produced under a different CacheSpec: "
                        f"{saved.to_json()} != {self.spec.to_json()}"
                    )
        # the checkpoint's live allocation, staged until the arrays load
        pending_cache = None
        state_template = self.state
        raw = ckpt_lib.load_leaf(ckpt_dir, step, "alloc_json")
        if raw is not None:
            saved_cfg = DeviceCacheConfig.from_json(bytes(np.asarray(raw)).decode("utf-8"))
            if saved_cfg != self.cache.cfg:
                self._check_allocation_compatible(saved_cfg)
                pending_cache = STDDeviceCache(saved_cfg, device=self.device)
                state_template = dict(pending_cache.init_state)
                # the static layer is read-only and untouched by rebalance:
                # its shapes validate the checkpoint's
                for k in ("static_hi", "static_lo", "static_value"):
                    state_template[k] = self.state[k]
        stats_tree = self._stats_tree()
        if (
            "topic_counts" in stats_tree
            and ckpt_lib.load_leaf(ckpt_dir, step, "stats/topic_counts") is None
        ):
            # checkpoint predates the tracker: the tracker cold-starts
            del stats_tree["topic_counts"]
        tree_like = {"cache": state_template, "stats": stats_tree}
        if (
            self.freshness is not None
            and ckpt_lib.load_leaf(ckpt_dir, step, "freshness/floors") is not None
        ):
            # freshness leaves restore only when both sides have them
            tree_like["freshness"] = self.freshness.tree()
        tree, got = ckpt_lib.restore(ckpt_dir, tree_like, step)
        state = state_from_numpy(tree["cache"], self.device)
        if pending_cache is not None:
            self._bind_cache(pending_cache)
        if "freshness" in tree:
            self.freshness.load(tree["freshness"])
        self.state = state
        for k, v in tree["stats"].items():
            if k == "topic_counts":
                # in place, so stats keeps sharing the tracker's array
                self.tracker.load(np.asarray(v, np.float64))
            else:
                setattr(self.stats, k, int(v))
        return got

    def _check_allocation_compatible(self, saved_cfg: DeviceCacheConfig) -> None:
        """Only the per-topic split may differ from the running config --
        anything else means the checkpoint belongs to a different
        deployment and fails informatively, like the spec checks."""
        cur = self.cache.cfg
        same_universe = (
            saved_cfg.total_entries == cur.total_entries
            and saved_cfg.ways == cur.ways
            and saved_cfg.value_dim == cur.value_dim
            and saved_cfg.static_entries == cur.static_entries
            and saved_cfg.dynamic_entries == cur.dynamic_entries
            and set(saved_cfg.topic_entries) == set(cur.topic_entries)
        )
        if not same_universe:
            raise ValueError(
                "checkpoint allocation is incompatible with this broker's "
                f"cache layout (not just a topic re-split): {saved_cfg.to_json()} "
                f"!= {cur.to_json()}"
            )
