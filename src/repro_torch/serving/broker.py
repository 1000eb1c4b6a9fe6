"""Front-end broker (paper Fig. 2) on PyTorch: cache -> backend -> reply.

Port of ``repro.serving.broker`` for the fused serving paths.  Per batch:

1. hash + topic-route every query on the host, and pad the batch up to
   its shape bucket with the reserved never-resident pad key;
2. one fused serve call on the device.  On the default path
   (``fused_one_call``) the previous batch's deferred value fill, the
   probe, the commit and the probed value-row gather are one call of the
   serve kernel (``STDDeviceCache.serve_one_call``), counted per call in
   ``Broker.dispatch_counts``.  ``fused_one_call=False`` keeps the legacy
   pair of entry points (``fused`` / ``fused_fill``), which run the
   probe/commit kernel;
3. misses go to a backend in micro-batches with hedged requests;
4. backend results are scattered into the slots the fused call reserved
   (deferred value fill), riding inside the next batch's call.  ``flush()``
   applies a pending fill on demand.

There is no jit: ``trace_counts`` stays empty.  ``warmup`` builds the
kernels and makes one warm launch of every serving entry per bucket shape.

Not ported yet (each raises ``NotImplementedError`` naming its
``ROADMAP.md`` item): the host engine, the unfused three-call path
(``fused=False``), live rebalancing, checkpoints (``save``/``restore``),
key invalidation (``invalidate(keys=...)``) and ``from_spec``.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..freshness import FreshnessRuntime, FreshnessSpec
from .device_cache import (
    PAD_H64,
    STDDeviceCache,
    pack_hashes,
    pad_batch,
    resolve_device,
    splitmix64,
    to_device_words,
)
from .spec import BucketSpec


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, Queue 1 {item})"
    )


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
    #: non-empty batches served
    batches: int = 0
    #: live repartitions applied by the drift rebalancer (not ported: 0)
    rebalances: int = 0
    #: resident entries carried into new layouts (not ported: 0)
    migrated: int = 0
    #: cluster resilience counters (the cluster is not ported: 0)
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
    #: invalidation events applied
    invalidations: int = 0
    #: the popularity tracker's counts (rebalancing is not ported: None)
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
        spec=None,
        fused: bool = True,
        engine: str = "auto",
        rebalance=None,
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
        if spec is not None:
            raise _not_ported("a CacheSpec-compiled broker", "item 4")
        if engine == "host":
            raise _not_ported('engine="host"', "item 3")
        if engine not in ("auto", "device"):
            raise ValueError(f"engine must be auto|host|device, got {engine!r}")
        if not fused:
            raise _not_ported("the unfused three-call path (fused=False)", "item 6")
        if rebalance is not None:
            raise _not_ported("live rebalancing (RebalanceSpec)", "item 6")
        self.cache = cache
        # the kernels update ks and value in place, so the broker owns its
        # copy of the mutable words; the static layer is read-only and shared
        self.state = {
            k: v.clone() if k in ("ks", "value", "clock") else v
            for k, v in cache.init_state.items()
        }
        self.backends = list(backends)
        self.topic_of = topic_of
        self.admission = admission
        self.hedge = hedge
        self.microbatch = microbatch
        #: in-flight request coalescing: duplicate keys inside one batch
        #: are dispatched to the backend only once
        self.coalesce = coalesce
        #: whether warmup() runs at construction
        self.aot_warmup = bool(aot_warmup)
        #: static-shape contract: pad batches up to shape buckets with the
        #: reserved pad key (pow2 unless told otherwise)
        if bucket is None:
            bucket = BucketSpec()
        self.bucket: Optional[BucketSpec] = bucket if bucket.enabled else None
        #: double-buffer the deferred value fill into the next fused call
        self.defer_fill = True if defer_fill is None else bool(defer_fill)
        #: one-dispatch serving: the deferred fill, probe, commit and value
        #: gather share one entry point (one serve-kernel call per batch).
        #: False keeps the legacy ``fused``/``fused_fill`` pair.
        self.fused_one_call = bool(fused_one_call)
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
        self.stats = BrokerStats()
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

    @classmethod
    def from_spec(cls, *args, **kwargs) -> "Broker":
        raise _not_ported("Broker.from_spec (ServingSpec/CacheSpec)", "item 4")

    def _counted(self, name: str, fn):
        """Wrap an entry point so every call bumps ``dispatch_counts[name]``."""
        counts = self.dispatch_counts

        def wrapper(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)

        return wrapper

    def _bind_cache(self, cache: STDDeviceCache) -> None:
        """Bind the serving entry points to ``cache`` (and warm them up
        when ``aot_warmup``)."""
        self.cache = cache
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
        warmed by this call."""
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
            if self.fused_one_call:
                self._one_call_step(self.state, *self._pad_plan(None, s), *args)
            else:
                self._fused_step(self.state, *args)
                self._fused_fill_step(self.state, *self._pad_plan(None, s), *args)
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
        out = self._serve_fused(query_ids, parts, h_hi, h_lo, min_ep, eps)
        self._after_batch(topics)
        return out

    def _pad_to_bucket(self, h_hi, h_lo, parts):
        """Pad the request arrays up to the batch's shape bucket with the
        reserved pad key (routed at the dynamic partition)."""
        b = len(h_hi)
        bp = self.bucket.padded_len(b) if self.bucket is not None else b
        self.stats.padded += max(bp - b, 0)
        h_hi, h_lo, parts, _, _ = pad_batch(h_hi, h_lo, parts, self.cache.k, bp)
        return h_hi, h_lo, parts

    def _after_batch(self, topics: np.ndarray) -> None:
        """Post-serve bookkeeping: advance the batch clock."""
        if len(topics):
            self.stats.batches += 1

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
        set_t, wrote_t, way_t = plan_t
        # one device -> host copy for everything the host needs
        cols = [value_t] + [
            t.to(torch.int32)[:, None]
            for t in (hit_t, layer_t, stale_t, set_t, wrote_t, way_t)
        ]
        host = torch.cat(cols, 1).cpu().numpy()
        v = value_t.shape[1]
        values = host[:, :v].copy()  # (bp, V) writable; sliced on return
        hit = host[:b, v] != 0
        layer = host[:b, v + 1]
        stale = host[:b, v + 2] != 0
        set_idx, wrote_np, way = host[:, v + 3], host[:, v + 4] != 0, host[:, v + 5]
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
            if self.defer_fill:
                # double-buffer: the plan lands inside the next fused call
                # (or flush()); the next probe reads values post-fill
                sel = np.flatnonzero(wrote_np)
                with self._fill_lock:
                    self._pending_fill = (set_idx[sel], way[sel], fill_vals[sel])
            else:
                self.state = self._fill(
                    self.state, set_t, wrote_t, way_t,
                    torch.from_numpy(np.ascontiguousarray(fill_vals)).to(self.device),
                )
        self.stats.requests += b
        self.stats.hits += int(hit.sum())
        self.stats.static_hits += int(((layer == 0) & hit).sum())
        self.stats.topic_hits += int(((layer == 1) & hit).sum())
        return values[:b], hit

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

    def invalidate(self, keys: Optional[np.ndarray] = None, topic: Optional[int] = None) -> int:
        """Invalidate cached results by topic (``topic=-1``: everything).

        O(1): the topic's partition floor jumps above the current epoch and
        every resident entry of the partition expires at once.  Needs a
        :class:`FreshnessSpec`.  Key invalidation is not ported yet.
        """
        if (keys is None) == (topic is None):
            raise ValueError("invalidate() takes exactly one of keys= or topic=")
        if keys is not None:
            raise _not_ported("key invalidation (invalidate(keys=...))", "item 6")
        if self.freshness is None:
            raise ValueError(
                "topic invalidation uses epoch floors and needs a FreshnessSpec"
            )
        if int(topic) < 0:
            self.freshness.flush_all()
        else:
            part = int(self.cache.parts_for(np.asarray([int(topic)]))[0])
            self.freshness.flush_topic(part)
        self.stats.invalidations += 1
        return 0

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

    # -- not ported yet --------------------------------------------------------

    def rebalance(self, force: bool = False) -> bool:
        raise _not_ported("live rebalancing", "item 6")

    def save(self, ckpt_dir: str, step: int) -> str:
        raise _not_ported("broker checkpoints (save)", "item 5")

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        raise _not_ported("broker checkpoints (restore)", "item 5")
