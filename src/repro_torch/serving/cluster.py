"""Sharded multi-broker serving compiled from one ``ServingSpec`` (port of
``repro.serving.cluster``).

A :class:`Cluster` is N independent :class:`~repro_torch.serving.broker.Broker`
shards behind a scatter-gather front end (the paper's Fig. 2 broker,
scaled out).  Because the device cache's partitions never share sets,
splitting the partition/set axis across brokers creates no cross-shard
traffic beyond routing: every batch is hashed exactly once
(``ServingSpec.shard_of_hashes`` routes on the high word, the shard's
cache consumes the low word), each shard serves its slice independently,
and the results are scattered back into arrival order.

Pipelined async dispatch (``spec.dispatch``): with
a :class:`~repro_torch.serving.spec.DispatchSpec`, :meth:`Cluster.serve_async`
enqueues each batch's shard slices onto per-shard work queues and
returns a :class:`ClusterFuture` immediately.  Queued slices from
*consecutive* batches fuse into one broker call per shard (value- and
state-identical to serving them back-to-back; the hit mask is atomic
per fused call), results scatter into their futures in **completion
order** as shards finish, and the per-call fixed cost -- padding,
freshness arrays, the double-buffered fill -- amortizes across the
pipeline depth.  :meth:`serve` stays synchronous (it drains its own
batch immediately), so the conformance contract below survives with
``dispatch`` set; time only advances and checkpoints only cut at quiesce
points (every control-plane entry drains the queues first).

Conformance contract (the reference's, asserted for the port against the
JAX ``Cluster`` by ``tests/test_torch_cluster.py``):

* ``shards=1`` serves a replayed stream request-for-request identical
  to a bare broker built from the same spec -- values, hit mask, and
  per-layer stats;
* hash routing with N > 1 matches the bare broker hit-for-hit on
  duplicate-free streams (the static layer is partitioned without loss,
  and LRU behaviour only diverges once eviction patterns matter).

Checkpoints: :meth:`Cluster.save` writes one per-shard broker
checkpoint plus a single ``cluster.json`` manifest embedding the
``ServingSpec``; :meth:`Cluster.restore` verifies shard count and spec
*before* touching any cache arrays, so a mismatched restore fails with
the informative ``ValueError`` instead of a shape mismatch.

Resilience (``spec.resilience``): per-shard
dispatch gets bounded retries with seeded exponential backoff, a
health state machine with circuit-breaker re-probes, degraded
miss-through for queries routed to a down shard (identical values --
the backend is the source of truth -- at a hit-rate/latency cost), and
checkpoint-verified warm recovery via :meth:`recover_shard`.  Faults
are *injected* per shard with :meth:`inject_shard_faults`
(:class:`repro_torch.loadgen.inject.FaultInjectSpec`); the open-loop harness
drives the virtual clock through :meth:`advance_time` so whole fault
episodes replay bit-identically.

Placement: shard ``i``'s cache is built on ``shard_devices(N)[i]``
(:mod:`repro_torch.launch.mesh`), round-robin over the cards, so with one
card every shard shares ``cuda:0``.  Shard threads (``parallel``; by
default only when the shards span several devices, where the reference
threads every device-engine cluster) launch onto their device's current
stream: on one device stream order serialises the shards' kernels, and
threads only contend for the GIL.  ``dispatch_counts`` counts the serving
entry points' calls.  With :mod:`.tracing` on, ``serve`` records the span
``cluster.serve``, the parent of its shards' ``broker.*`` spans.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..freshness import FreshnessRuntime
from ..train import checkpoint as ckpt_lib
from . import tracing
from .broker import Backend, Broker, BrokerStats
from .device_cache import STDDeviceCache, splitmix64
from .resilience import DOWN, ShardHealth
from .spec import DispatchSpec, ServingSpec

MANIFEST_NAME = "cluster.json"


def _shard_dir(ckpt_dir: str, i: int) -> str:
    return os.path.join(ckpt_dir, f"shard_{i:03d}")


#: sentinel returned by a dispatch attempt whose retry was *rescheduled*
#: (backoff) instead of slept out in the worker -- the scheduler re-runs
#: the call once its deadline passes, without pinning a pool slot
_RETRY = object()


class _ShardCall:
    """One shard's slice of work: the unit the dispatch scheduler runs.

    Carries its own retry state (attempt counter, backoff deadline in
    wall seconds, dispatch sequence number) so the scheduler can park it
    between attempts while other shards' calls proceed."""

    __slots__ = (
        "i", "query_ids", "topics", "h64", "on_done",
        "attempt", "seq", "err", "not_before",
    )

    def __init__(self, i, query_ids, topics, h64, on_done):
        self.i = i
        self.query_ids = query_ids
        self.topics = topics
        self.h64 = h64
        self.on_done = on_done
        self.attempt = 0
        self.seq: Optional[int] = None
        self.err: Optional[Exception] = None
        self.not_before = 0.0  # wall-clock deadline for the next attempt


class ClusterFuture:
    """Result handle for one batch submitted via :meth:`Cluster.serve_async`.

    ``values``/``hit`` are preallocated in arrival order and filled in
    *completion order* as shard calls finish; :meth:`result` drains the
    cluster's work queues until every slice of this batch has landed.
    The future is not thread-safe -- it is a pipelining handle for the
    submitting thread, not a synchronization primitive."""

    def __init__(self, cluster: "Cluster", n: int):
        self._cluster = cluster
        self.values = np.zeros((n, cluster.spec.value_dim), np.int32)
        self.hit = np.zeros(n, bool)
        self._remaining = 0  # shard slices still queued or in flight

    def done(self) -> bool:
        return self._remaining == 0

    def result(self):
        """(values (B, V), hit mask) -- drives the queues to completion."""
        self._cluster._drain_until(self)
        return self.values, self.hit


class Cluster:
    """N spec-compiled broker shards behind one serve() front end."""

    def __init__(
        self,
        spec: ServingSpec,
        brokers: Sequence[Broker],
        topic_of: Callable[[np.ndarray], np.ndarray],
        parallel: Optional[bool] = None,
    ):
        if len(brokers) != spec.shards:
            raise ValueError(
                f"spec declares {spec.shards} shards but {len(brokers)} "
                "brokers were provided"
            )
        self.spec = spec
        self.brokers = list(brokers)
        self.topic_of = topic_of
        # scatter-gather pool: shards are independent, so their serves can
        # overlap -- but only where their device work can.  Shards on one
        # device launch onto one stream, so threads overlap nothing there,
        # and the shards' host work (~100 small torch calls a serve, each
        # giving up and retaking the GIL) convoys: on an H100, 4 threaded
        # shards took 32-34 ms a batch of 4096 against 9.5-9.9 serially
        # (PERF.md).  The pure-numpy host engine is GIL-bound too.
        # So the default threads only shards spread over several devices;
        # pass ``parallel=True`` when backend latency dominates.
        if parallel is None:
            parallel = len({b.device for b in brokers if b.engine == "device"}) > 1
        self._pool = (
            ThreadPoolExecutor(max_workers=len(brokers))
            if parallel and len(brokers) > 1
            else None
        )
        self._closed = False
        #: per-shard health machines (None without a ResilienceSpec: any
        #: shard failure propagates, the pre-resilience behaviour)
        self._health: Optional[List[ShardHealth]] = (
            [ShardHealth(spec.resilience) for _ in brokers]
            if spec.resilience is not None
            else None
        )
        #: per-shard fault injectors (tests/benchmarks attach these)
        self._injectors: List[Optional[object]] = [None] * len(brokers)
        #: where a down shard warm-restarts from (set by save/restore or
        #: attach_recovery; None = recovery re-inits the shard cold)
        self._recovery_dir: Optional[str] = None
        self._corrupted = [False] * len(brokers)
        #: per-shard dispatch sequence numbers (backoff jitter seeding)
        self._seq = [0] * len(brokers)
        #: invalidation events that arrived while a shard was DOWN,
        #: replayed on top of the restored checkpoint by recover_shard
        #: (the checkpoint may predate the event)
        self._pending_inval: List[list] = [[] for _ in brokers]
        # virtual clock: the open-loop harness drives it via advance_time
        # (deterministic fault episodes); otherwise relative wall time
        self._now = 0.0
        self._virtual = False
        self._t0 = time.monotonic()
        #: per-shard work queues for pipelined async dispatch: deques of
        #: (future, out_idx, query_ids, topics, h64) slices
        self._queues: List[deque] = [deque() for _ in brokers]
        #: counters carried across elastic reshards (old shards' stats)
        self._carried: Optional[BrokerStats] = None
        # cluster-side accounting for fused-call duplicate collapsing
        self._dup_stats = BrokerStats()
        #: from_spec construction closure for elastic resharding (None
        #: for hand-built clusters, which cannot reshard)
        self._factory: Optional[dict] = None

    # -- construction ------------------------------------------------------

    @classmethod
    def from_spec(
        cls,
        spec: ServingSpec,
        stats,
        backends: Sequence[Backend],
        topic_of: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        value_fn=None,
        log=None,
        admitted: Optional[np.ndarray] = None,
        parallel: Optional[bool] = None,
        device="cuda",
    ) -> "Cluster":
        """Compile the spec into N brokers owning disjoint cache slices.

        ``stats`` is the vectorized :class:`repro_torch.core.fast.VecStats`;
        ``value_fn(key_ids) -> (n, value_dim)`` preloads static values;
        ``log``/``admitted`` feed the admission gate exactly as in
        :meth:`repro_torch.core.spec.AdmissionSpec.to_serving_gate`.  The
        static layer is partitioned by the same routing as live queries,
        so every static key keeps answering on the shard that serves it.
        Shard ``i``'s cache is built directly on ``shard_devices(N,
        device=device)[i]``: round-robin over the cards for ``"cuda"``,
        every shard on the CPU for ``"cpu"`` (the plain versions, or the
        numpy host engine with ``spec.engine="host"``).
        """
        from ..launch.mesh import shard_devices  # deferred: launch imports serving

        devices = shard_devices(spec.shards, device=device)
        key_topic = np.asarray(stats.key_topic)
        if topic_of is None:
            topic_of = lambda q: key_topic[np.asarray(q, np.int64)]  # noqa: E731
        # compile the gate once; Broker.from_spec then owns the rest of the
        # spec compilation, so a broker and a shard can never drift apart
        gate = spec.cache.admission.to_serving_gate(log=log, admitted=admitted)
        static_keys = spec.cache.device_static_keys(stats)
        static_shard = spec.shard_of(static_keys, topics=key_topic[static_keys])
        configs = spec.device_configs(stats.topic_distinct)
        brokers = []
        for i, cfg in enumerate(configs):
            keys_i = static_keys[static_shard == i]
            cache = STDDeviceCache(
                cfg,
                static_hashes=splitmix64(keys_i) if len(keys_i) else None,
                static_values=(
                    value_fn(keys_i) if value_fn is not None and len(keys_i) else None
                ),
                device=devices[i],
            )
            broker = Broker.from_spec(
                spec, stats, backends, topic_of=topic_of, admission=gate,
                cache=cache, device=devices[i],
            )
            if spec.shards > 1:
                # distinct per-shard identity in the embedded spec, so
                # restoring the wrong shard's checkpoint fails the
                # informative spec check rather than a shape mismatch
                broker.spec = dataclasses.replace(
                    spec.cache,
                    name=f"{spec.cache.name or 'cache'}:shard{i}of{spec.shards}",
                )
            brokers.append(broker)
        cluster = cls(spec, brokers, topic_of, parallel=parallel)
        # everything needed to rebuild the shard set at a different
        # count: elastic resharding re-runs this compilation, then
        # migrates the live entries in (see reshard())
        cluster._factory = dict(
            stats=stats, backends=backends, topic_of=topic_of,
            value_fn=value_fn, log=log, admitted=admitted, parallel=parallel,
            device=device,
        )
        return cluster

    # -- serving -----------------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                "Cluster.serve called after close(); the shard brokers and "
                "scatter-gather pool are shut down -- build a new cluster "
                "(or restore one from a checkpoint) to keep serving"
            )

    def _route(self, query_ids: np.ndarray):
        """Hash + topic-route one batch exactly once.

        Returns ``(topics, h64, shard)``.  ``h64``/``shard`` are None at
        shards=1 (nothing to route; the broker hashes itself, so the
        single-shard path stays byte-for-byte the bare broker's)."""
        topics = (
            np.asarray(self.topic_of(query_ids))
            if self.spec.routing == "topic"
            else None
        )
        if self.spec.shards == 1:
            return topics, None, None
        h64 = splitmix64(query_ids)
        return topics, h64, self.spec.shard_of_hashes(h64, topics=topics)

    def serve(self, query_ids: np.ndarray):
        """Serve one batch -> (values (B, V), hit mask), arrival order.

        Routes every request to its shard (one splitmix64 pass, shared
        with the shards' set indexing), serves the shard slices, and
        scatters results back into the caller's order **as each shard
        completes** -- one slow shard never blocks collection of the
        others, and a failure surfaces as soon as it happens.  Within a
        shard the slice preserves arrival order, so per-shard semantics
        are exactly the broker's.  Synchronous: the batch is dispatched
        and drained before returning (use :meth:`serve_async` to
        pipeline consecutive batches).
        """
        self._check_open()
        query_ids = np.asarray(query_ids)
        b = len(query_ids)
        with tracing.span("cluster.serve", b):
            topics, h64, shard = self._route(query_ids)
            values = np.zeros((b, self.spec.value_dim), np.int32)
            hit = np.zeros(b, bool)
            if shard is None:
                if b:
                    v, h = self._serve_shard(0, query_ids, topics)
                    values[:], hit[:] = v, h
                return values, hit
            calls = []
            for i in range(len(self.brokers)):
                idx = np.flatnonzero(shard == i)
                if not len(idx):
                    continue

                def on_done(v, h, idx=idx):
                    values[idx] = v
                    hit[idx] = h

                calls.append(
                    _ShardCall(
                        i, query_ids[idx],
                        None if topics is None else topics[idx],
                        h64[idx], on_done,
                    )
                )
            self._execute(calls)
            return values, hit

    # -- pipelined async dispatch ------------------------------------------

    def _dispatch_spec(self) -> DispatchSpec:
        return self.spec.dispatch if self.spec.dispatch is not None else DispatchSpec()

    def serve_async(self, query_ids: np.ndarray) -> ClusterFuture:
        """Enqueue one batch; returns a :class:`ClusterFuture` whose
        ``result()`` drains it (and everything queued before it).

        The pipelined front end: each shard's slice joins that shard's
        work queue, and queued slices from consecutive batches fuse into
        one broker call per shard (``spec.dispatch`` bounds the fusion
        depth/size and the queue length -- past ``max_queue`` the
        enqueue drains synchronously as backpressure).  Fused serving is
        value- and state-identical to serving the batches back-to-back;
        the hit mask is atomic per fused call, so a key repeated across
        fused batches counts its repeats as misses exactly as repeats
        *within* one batch always have.  Control-plane entry points
        (``advance_time``, ``flush``, ``save``, ``rebalance``,
        ``invalidate``, ``reshard``, ``close``) drain the queues first,
        so queued work never straddles a clock step or a checkpoint.
        """
        self._check_open()
        query_ids = np.asarray(query_ids)
        fut = ClusterFuture(self, len(query_ids))
        if len(query_ids) == 0:
            return fut
        topics, h64, shard = self._route(query_ids)
        if shard is None:
            self._queues[0].append(
                (fut, slice(None), query_ids, topics, None)
            )
            fut._remaining = 1
        else:
            for i in range(len(self.brokers)):
                idx = np.flatnonzero(shard == i)
                if not len(idx):
                    continue
                self._queues[i].append(
                    (
                        fut, idx, query_ids[idx],
                        None if topics is None else topics[idx],
                        h64[idx],
                    )
                )
                fut._remaining += 1
        max_queue = self._dispatch_spec().max_queue
        while any(len(q) > max_queue for q in self._queues):
            self._drain_step()
        return fut

    def _drain_until(self, fut: ClusterFuture) -> None:
        while fut._remaining > 0:
            self._drain_step()

    def _drain_pending(self) -> None:
        """Serve everything queued (the quiesce point every control-plane
        entry goes through)."""
        while any(self._queues):
            self._drain_step()

    def _drain_step(self) -> None:
        """One scheduler round: pop a fused group per busy shard and run
        them all, completion-ordered."""
        d = self._dispatch_spec()
        calls = []
        for i, q in enumerate(self._queues):
            if not q:
                continue
            segs = [q.popleft()]
            nreq = len(segs[0][2])
            while (
                d.pipeline
                and q
                and len(segs) < d.max_fuse
                and nreq + len(q[0][2]) <= d.fuse_requests
            ):
                seg = q.popleft()
                nreq += len(seg[2])
                segs.append(seg)
            calls.append(self._fused_call(i, segs))
        self._execute(calls)

    def _fused_call(self, i: int, segs: list) -> _ShardCall:
        """Concatenate queued slices into one shard call whose completion
        scatters each slice back into its own future."""
        if len(segs) == 1:
            fut, idx, qids, topics, h64 = segs[0]

            def on_done(v, h, fut=fut, idx=idx):
                fut.values[idx] = v
                fut.hit[idx] = h
                fut._remaining -= 1

            return _ShardCall(i, qids, topics, h64, on_done)
        qids = np.concatenate([s[2] for s in segs])
        topics = (
            np.concatenate([s[3] for s in segs])
            if segs[0][3] is not None
            else None
        )
        h64 = (
            np.concatenate([s[4] for s in segs])
            if segs[0][4] is not None
            else None
        )
        offs = np.cumsum([0] + [len(s[2]) for s in segs])
        # cross-batch duplicates collapse to one served request: the cache
        # and backend see each key once per fused call, and every duplicate
        # scatters that one serve's value/hit.  The call keeps each key's
        # LAST occurrence, in arrival order, so the commit stamps land
        # where sequential serving's final recency refresh would (a
        # duplicate-free fused call replays bit-exactly; with duplicates
        # only the skipped *earlier* occurrences' transient recency is
        # approximated -- values never change).  Duplicates are counted
        # cluster-side (requests/hits/coalesced) so the aggregate stats
        # still cover every submitted request.
        ident = h64 if h64 is not None else qids
        uniq, inv = np.unique(ident, return_inverse=True)
        if len(uniq) < len(ident):
            last = np.zeros(len(uniq), np.int64)
            last[inv] = np.arange(len(ident))  # duplicate writes: last wins
            sel = np.sort(last)  # last occurrences, arrival order
            pos = np.empty(len(uniq), np.int64)
            pos[np.argsort(last, kind="stable")] = np.arange(len(uniq))
            inv = pos[inv]  # request -> its key's row in the fused call
            call_qids = qids[sel]
            call_topics = topics[sel] if topics is not None else None
            call_h64 = h64[sel] if h64 is not None else None
        else:
            inv = None
            call_qids, call_topics, call_h64 = qids, topics, h64

        def on_done(v, h):
            if inv is not None:
                ds = self._dup_stats
                ds.requests += len(inv) - len(h)
                ds.coalesced += len(inv) - len(h)
                v = v[inv]
                h_full = h[inv]
                ds.hits += int(h_full.sum()) - int(h.sum())
                h = h_full
            for (fut, idx, _, _, _), lo, hi in zip(segs, offs[:-1], offs[1:]):
                fut.values[idx] = v[lo:hi]
                fut.hit[idx] = h[lo:hi]
                fut._remaining -= 1

        return _ShardCall(i, call_qids, call_topics, call_h64, on_done)

    # -- resilient dispatch ------------------------------------------------

    def advance_time(self, t: float) -> None:
        """Move the cluster's virtual clock to ``t`` (monotone; the
        open-loop harness calls this with each batch's dispatch time).
        Once called, health timestamps, probe cadence, and injected fault
        schedules all run on virtual time -- deterministic replay."""
        self._drain_pending()  # queued work serves at its submission time
        t = float(t)
        self._virtual = True
        self._now = max(self._now, t)
        for inj in self._injectors:
            if inj is not None:
                inj.advance_to(t)
        # the freshness clocks tick on the same virtual time, so TTL
        # expiry replays as deterministically as the fault episodes
        for b in self.brokers:
            b.advance_time(t)

    def _clock(self) -> float:
        return self._now if self._virtual else time.monotonic() - self._t0

    def inject_shard_faults(self, shard: int, fault_spec):
        """Attach a fault schedule to one shard's dispatch; returns the
        compiled :class:`~repro_torch.loadgen.inject.FaultInjector`.  Without a
        ``ResilienceSpec`` on the serving spec, injected faults propagate
        to the caller (the pre-resilience behaviour)."""
        from ..loadgen.inject import FaultInjector  # deferred: loadgen imports serving

        inj = (
            fault_spec
            if isinstance(fault_spec, FaultInjector)
            else FaultInjector(fault_spec)
        )
        self._injectors[int(shard)] = inj
        return inj

    def attach_recovery(self, ckpt_dir: str) -> None:
        """Point shard recovery at a cluster checkpoint directory (done
        automatically by :meth:`save`/:meth:`restore`)."""
        self._recovery_dir = ckpt_dir

    @property
    def shard_health(self) -> Optional[List[ShardHealth]]:
        """Per-shard health machines (None without a ResilienceSpec)."""
        return self._health

    def _call_shard(self, i: int, query_ids, topics, h64=None):
        """One dispatch attempt: injected faults fire first (they model
        the shard being unreachable -- the broker is never entered)."""
        inj = self._injectors[i]
        if inj is not None:
            inj.check(self._clock(), n=len(query_ids))
        return self.brokers[i].serve(query_ids, topics, h64=h64)

    def _serve_shard(self, i: int, query_ids, topics, h64=None):
        """Serve one shard slice to completion (inline retries)."""
        call = _ShardCall(i, query_ids, topics, h64, None)
        out = self._attempt(call)
        while out is _RETRY:
            delay = call.not_before - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            out = self._attempt(call)
        return out

    def _execute(self, calls: List[_ShardCall]) -> None:
        """Run shard calls to completion, scattering each through its
        ``on_done`` in **completion order**.

        Retry backoffs never occupy a worker: an attempt that must back
        off returns to the scheduler with a wall-clock deadline and the
        slot serves other shards meanwhile (virtual-clock runs skip the
        delay entirely, bit-exact with the pre-async behaviour).  A
        failure raises as soon as it completes -- it is never stuck
        behind a slower healthy shard."""
        if not calls:
            return
        if self._pool is not None and len(calls) > 1:
            self._execute_threaded(calls)
            return
        pending = list(calls)
        while pending:
            now_w = time.monotonic()
            ready = next((c for c in pending if c.not_before <= now_w), None)
            if ready is None:
                # only backed-off retries remain: wait out the earliest
                ready = min(pending, key=lambda c: c.not_before)
                delay = ready.not_before - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            pending.remove(ready)
            out = self._attempt(ready)
            if out is _RETRY:
                pending.append(ready)
            else:
                ready.on_done(*out)

    def _execute_threaded(self, calls: List[_ShardCall]) -> None:
        pending = list(calls)  # backed off / not yet submitted
        futs = {}
        while pending or futs:
            now_w = time.monotonic()
            for c in [c for c in pending if c.not_before <= now_w]:
                pending.remove(c)
                futs[self._pool.submit(tracing.bind(self._attempt), c)] = c
            if not futs:
                delay = min(c.not_before for c in pending) - time.monotonic()
                if delay > 0:
                    time.sleep(delay)  # scheduler waits, no pool slot pinned
                continue
            timeout = (
                max(0.0, min(c.not_before for c in pending) - time.monotonic())
                if pending
                else None
            )
            done, _ = wait(list(futs), timeout=timeout, return_when=FIRST_COMPLETED)
            for f in done:
                c = futs.pop(f)
                out = f.result()  # first failure surfaces immediately
                if out is _RETRY:
                    pending.append(c)
                else:
                    c.on_done(*out)

    def _attempt(self, c: _ShardCall):
        """One resilient dispatch attempt for ``c``; returns the shard's
        ``(values, hit)``, a degraded result, or :data:`_RETRY` with
        ``c.not_before`` set to the backoff deadline.

        Service time is taken from the clock the episode runs on
        (``self._clock()``): under the harness's virtual clock a
        completed serve measures zero elapsed virtual time, so
        cooperative-timeout detection never depends on wall-clock noise
        and fault episodes replay bit-identically."""
        if self._health is None:
            return self._call_shard(c.i, c.query_ids, c.topics, c.h64)
        res = self.spec.resilience
        i = c.i
        h = self._health[i]
        if c.seq is None:
            # first attempt: circuit-breaker gate, then claim a dispatch
            # sequence number (backoff jitter seeding, one per dispatch)
            if h.state == DOWN:
                if not h.probe_due(self._clock()):
                    return self._serve_degraded(i, c.query_ids)
                # circuit-breaker probe: try to warm-restart the shard,
                # then let this very batch be the probe dispatch
                h.counters.probes += 1
                try:
                    self.recover_shard(i)
                except Exception:
                    h.probe_failed(self._clock())
                    return self._serve_degraded(i, c.query_ids)
            c.seq = self._seq[i]
            self._seq[i] = c.seq + 1
        attempts = res.max_retries + 1
        try:
            t_start = self._clock()
            out = self._call_shard(i, c.query_ids, c.topics, c.h64)
        except Exception as e:
            c.err = e
            h.record_failure(self._clock())
            if h.state != DOWN and c.attempt + 1 < attempts:
                h.counters.retried += 1
                delay = res.backoff_s(i, c.seq, c.attempt)
                c.attempt += 1
                # reschedule instead of sleeping in the slot; virtual
                # runs retry immediately (the clock only moves at
                # advance_time), exactly as before
                c.not_before = (
                    time.monotonic() + delay
                    if delay > 0 and not self._virtual
                    else 0.0
                )
                return _RETRY
            # circuit opened mid-dispatch or retries exhausted: fail over
            h.counters.failed_over += len(c.query_ids)
            if res.failover == "fail":
                raise c.err if c.err is not None else RuntimeError(
                    f"shard {i} dispatch failed with failover policy 'fail'"
                )
            return self._serve_degraded(i, c.query_ids)
        # completed: a slow serve still counts as a timeout *failure* for
        # the health machine, but its result is used -- the broker is
        # single-writer, so a completed serve is never discarded
        dt_us = (self._clock() - t_start) * 1e6
        if res.timeout_us > 0 and dt_us > res.timeout_us:
            h.counters.timeouts += 1
            h.record_failure(self._clock())
        else:
            h.record_success(self._clock())
        return out

    def _serve_degraded(self, i: int, query_ids):
        """Miss-through for a down shard: serve its slice straight from
        the backend in arrival order.  Cache values equal backend values
        by construction (the backend is the source of truth the cache
        fills from), so degraded results are request-identical -- only
        the hit mask and latency change."""
        res = self.spec.resilience
        if res is None or res.failover == "fail":
            raise RuntimeError(
                f"shard {i} is unavailable and the failover policy is "
                "'fail'; no degraded path is configured"
            )
        h = self._health[i]
        backend = self.brokers[i].backends[0]
        mb = max(self.spec.microbatch, 1)
        vals = []
        for lo in range(0, len(query_ids), mb):
            vals.append(np.asarray(backend(query_ids[lo : lo + mb]), np.int32))
            h.counters.degraded_calls += 1
        h.counters.degraded += len(query_ids)
        values = (
            np.concatenate(vals, axis=0)
            if vals
            else np.zeros((0, self.spec.value_dim), np.int32)
        )
        return values, np.zeros(len(query_ids), bool)

    def recover_shard(self, i: int) -> Optional[int]:
        """Warm-restart shard ``i`` as a replacement process would: clear
        the crash latch, re-init the in-memory state (the static layer's
        preloaded arrays survive -- they are rebuilt at deploy, not
        learned), then restore the newest *manifest-verified* checkpoint
        step when a recovery dir is attached.  Returns the restored step
        (None = cold restart).  A corrupt newest step (torn write or
        tampered bytes) is detected by the manifest checksums and
        recovery falls back to the previous verified step."""
        from ..loadgen.inject import corrupt_checkpoint  # deferred: loadgen imports serving

        broker = self.brokers[i]
        inj = self._injectors[i]
        if inj is not None:
            if (
                inj.spec.corrupt_latest
                and not self._corrupted[i]
                and self._recovery_dir is not None
            ):
                # the crash tore the newest checkpoint: damage it once, so
                # recovery must prove it falls back to the previous step
                self._corrupted[i] = True
                sd = _shard_dir(self._recovery_dir, i)
                step = ckpt_lib.latest_step(sd)
                if step is not None:
                    corrupt_checkpoint(
                        os.path.join(sd, f"step_{step:010d}"),
                        mode="tamper",
                        seed=inj.spec.seed,
                    )
            inj.restart()
        # replacement process: in-memory cache state and stats are gone
        broker._pending_fill = None
        broker.state = Broker._own_state(broker.cache.init_state)
        for f in dataclasses.fields(BrokerStats):
            if f.name != "topic_counts":
                setattr(broker.stats, f.name, 0)
        if broker.tracker is not None:
            broker.tracker.load(np.zeros_like(broker.tracker.counts))
        if broker.freshness_spec is not None:
            # fresh clock; the restore below reloads the checkpointed
            # floors/time, and queued invalidations replay on top
            broker.freshness = FreshnessRuntime(
                broker.freshness_spec, broker.cache.topic_ids
            )
        restored: Optional[int] = None
        if self._recovery_dir is not None:
            sd = _shard_dir(self._recovery_dir, i)
            step = ckpt_lib.latest_verified_step(sd)
            if step is not None:
                broker.restore(sd, step=step)
                restored = step
        # invalidations that arrived during the outage: the checkpoint may
        # predate them, so they must land again before the shard serves
        for event in self._pending_inval[i]:
            self._exec_invalidation(broker, event)
        self._pending_inval[i] = []
        if self._health is not None:
            h = self._health[i]
            h.counters.recoveries += 1
            h.begin_recovery(self._clock())
        return restored

    # -- invalidation ------------------------------------------------------

    def invalidate(
        self,
        keys: Optional[np.ndarray] = None,
        topic: Optional[int] = None,
    ) -> int:
        """Cluster-wide invalidation, routed like the queries it affects.

        ``topic`` under topic routing goes to the single owner shard
        (``tau mod N``); under hash routing every shard holds a slice of
        the topic's partition, so the O(1) epoch bump fans out to all of
        them (still no cache words move).  ``topic=-1`` flushes every
        shard.  ``keys`` are grouped by ``shard_of`` and dropped
        shard-locally; returns the number of slots zeroed.

        Degraded-safe: an event for a DOWN shard is queued and replayed
        by :meth:`recover_shard` *after* the checkpoint restore -- the
        checkpoint may predate the event, and a recovered shard must not
        resurrect results the stream already invalidated.
        """
        if (keys is None) == (topic is None):
            raise ValueError("invalidate() takes exactly one of keys= or topic=")
        self._drain_pending()  # queued batches precede the event in stream order
        if topic is not None:
            if self.spec.routing == "topic" and int(topic) >= 0:
                targets = [int(topic) % self.spec.shards]
            else:
                targets = list(range(len(self.brokers)))
            for i in targets:
                self._route_invalidation(i, ("topic", int(topic)))
            return 0
        keys = np.asarray(keys)
        if len(keys) == 0:
            return 0
        topics = (
            np.asarray(self.topic_of(keys))
            if self.spec.routing == "topic"
            else None
        )
        shard = self.spec.shard_of(keys, topics=topics)
        n = 0
        for i in range(len(self.brokers)):
            sub = keys[shard == i]
            if len(sub):
                n += self._route_invalidation(i, ("keys", sub))
        return n

    def _route_invalidation(self, i: int, event) -> int:
        if self._health is not None and self._health[i].state == DOWN:
            self._pending_inval[i].append(event)
            return 0
        return self._exec_invalidation(self.brokers[i], event)

    @staticmethod
    def _exec_invalidation(broker: Broker, event) -> int:
        kind, arg = event
        if kind == "topic":
            return broker.invalidate(topic=arg)
        return broker.invalidate(keys=arg)

    # -- drift-aware rebalancing -------------------------------------------

    def rebalance(self, force: bool = False) -> List[bool]:
        """Run a rebalance check on every shard; returns per-shard outcomes.

        Rebalancing is shard-local by design: topic -> shard ownership is
        pure routing (``tau mod N``) and never moves, so each shard
        re-splits only its *own* topic partitions from its own tracked
        traffic and the disjoint-slice invariant holds after every
        rebalance with no cross-shard coordination.  Scheduled triggers
        (``RebalanceSpec.every``) fire inside each shard's serve path the
        same way.
        """
        self._drain_pending()
        return [b.rebalance(force=force) for b in self.brokers]

    # -- elastic resharding ------------------------------------------------

    def reshard(
        self,
        new_shards: int,
        ckpt_dir: Optional[str] = None,
        step: int = 0,
    ) -> "Cluster":
        """Split or merge the live shard set to ``new_shards`` brokers --
        no cold restart, the cluster keeps its handle and its history.

        The resize is the cross-shard generalization of the bucketed
        ``repartition`` path a live rebalance uses: pending pipelined
        work drains and every double-buffered fill lands (quiesce), the
        new shard set is compiled exactly as :meth:`from_spec` would
        (static layer re-partitioned by the new routing, by
        construction), every old shard's live entries are extracted
        (:meth:`STDDeviceCache.extract_live`), merged oldest-first on
        their recency stamps, re-routed on their *stored* hash words
        (``shard_of_hashes`` -- no original query ids needed), and
        bulk-inserted through the commit engines with insertion epochs
        preserved.  Freshness floors and the clock carry over (max per
        topic across the old shards), so a reshard can never resurrect
        an invalidated or expired entry.  Old counters keep aggregating
        through :attr:`stats`; health machines, injectors and dispatch
        queues rebuild fresh at the new width.

        ``ckpt_dir`` cuts a manifest-verified checkpoint of the resized
        cluster at ``step`` before returning (and points recovery at
        it) -- the grown cluster is immediately warm-restartable.
        Returns ``self``.
        """
        new_shards = int(new_shards)
        if new_shards < 1:
            raise ValueError(f"new_shards must be >= 1, got {new_shards}")
        self._check_open()
        if self._factory is None:
            raise ValueError(
                "reshard() needs a cluster built by Cluster.from_spec; a "
                "hand-built cluster has no shard compilation closure to "
                "rebuild its brokers from"
            )
        if new_shards == self.spec.shards:
            return self
        self._drain_pending()
        self.flush()  # pending fills are state; they must land pre-extract
        old_stats = self.stats  # aggregate incl. resilience + prior carries
        new_spec = dataclasses.replace(self.spec, shards=new_shards)
        f = self._factory
        fresh = Cluster.from_spec(
            new_spec, f["stats"], f["backends"], topic_of=f["topic_of"],
            value_fn=f["value_fn"], log=f["log"], admitted=f["admitted"],
            parallel=f["parallel"], device=f["device"],
        )
        # extract every old shard's live entries and merge oldest-first:
        # per-shard stamps count served requests, so cross-shard stamp
        # order is the best available global recency order
        parts = [b.cache.extract_live(b.state) for b in self.brokers]
        h64 = np.concatenate([p[0] for p in parts])
        topics = np.concatenate([p[1] for p in parts])
        vals = np.concatenate([p[2] for p in parts])
        eps = np.concatenate([p[3] for p in parts])
        stamps = np.concatenate([p[4] for p in parts])
        order = np.argsort(stamps, kind="stable")
        h64, topics, vals, eps = h64[order], topics[order], vals[order], eps[order]
        route = new_spec.shard_of_hashes(h64, topics=topics)
        for i, nb in enumerate(fresh.brokers):
            sel = route == i
            if sel.any():
                nb.state = nb.cache.bulk_insert(
                    nb.state, h64[sel], topics[sel], vals[sel], epochs=eps[sel],
                    engine="host" if nb.engine == "host" else "vec",
                    bucket=nb.bucket,
                )
                nb.stats.migrated += int(sel.sum())
        if self.spec.freshness is not None:
            self._carry_freshness(fresh.brokers)
        # adopt the new shard set; retire the old one
        for b in self.brokers:
            b.close()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        self.spec = new_spec
        self.brokers = fresh.brokers
        self._pool = fresh._pool
        self._health = fresh._health
        self._injectors = [None] * new_shards
        self._corrupted = [False] * new_shards
        self._seq = [0] * new_shards
        self._pending_inval = [[] for _ in range(new_shards)]
        self._queues = [deque() for _ in range(new_shards)]
        self._carried = old_stats  # already folds in _dup_stats: reset it
        self._dup_stats = BrokerStats()
        # old per-shard checkpoints have the wrong shard count now
        self._recovery_dir = None
        if self._virtual:
            for b in self.brokers:
                b.advance_time(self._now)
        if ckpt_dir is not None:
            self.save(ckpt_dir, step)
            for i in range(new_shards):
                got = ckpt_lib.latest_verified_step(_shard_dir(ckpt_dir, i))
                if got != step:
                    raise RuntimeError(
                        f"post-reshard checkpoint verification failed on shard "
                        f"{i}: expected step {step}, manifest verifies {got}"
                    )
        return self

    def _carry_freshness(self, new_brokers: Sequence[Broker]) -> None:
        """Carry invalidation floors (max per topic across old shards)
        and the freshness clock onto the new shard set."""
        topic_floor: dict = {}
        dyn_floor = 0
        now_s = 0.0
        min_now = 0
        for b in self.brokers:
            fr = b.freshness
            if fr is None:
                continue
            for t, p in b.cache.part_of_topic.items():
                topic_floor[t] = max(topic_floor.get(t, 0), int(fr.floors[p]))
            dyn_floor = max(dyn_floor, int(fr.floors[b.cache.k]))
            now_s = max(now_s, fr.now_s)
            min_now = max(min_now, fr._min_now)
        for nb in new_brokers:
            fr = nb.freshness
            if fr is None:
                continue
            fr.now_s = max(fr.now_s, now_s)
            fr._min_now = max(fr._min_now, min_now)
            for t, p in nb.cache.part_of_topic.items():
                if t in topic_floor:
                    fr.floors[p] = topic_floor[t]
            fr.floors[nb.cache.k] = dyn_floor

    # -- stats -------------------------------------------------------------

    @property
    def stats(self) -> BrokerStats:
        """Aggregate ``BrokerStats`` across every shard.

        Scalar counters sum; ``topic_counts`` stays None in the aggregate
        (each shard tracks its own disjoint topic universe -- read the
        per-shard trackers via ``shard_stats``).  Resilience accounting
        (degraded/retried/failed-over/timeout counters, kept cluster-side
        so a shard's restart never loses the outage's bookkeeping) is
        merged in: degraded requests count as requests, and their
        miss-through calls as backend calls.
        """
        agg = BrokerStats()
        parts = [b.stats for b in self.brokers] + [self._dup_stats]
        if self._carried is not None:
            # counters accumulated before an elastic reshard rebuilt the
            # shard set -- the deployment's history survives the resize
            parts.append(self._carried)
        for s in parts:
            for f in dataclasses.fields(BrokerStats):
                if f.name == "topic_counts":
                    continue
                setattr(agg, f.name, getattr(agg, f.name) + getattr(s, f.name))
        if self._health is not None:
            for h in self._health:
                self._merge_resilience(agg, h)
        return agg

    @staticmethod
    def _merge_resilience(s: BrokerStats, h: ShardHealth) -> None:
        c = h.counters
        s.requests += c.degraded
        s.degraded += c.degraded
        s.backend_calls += c.degraded_calls
        s.retried += c.retried
        s.failed_over += c.failed_over
        s.timeouts += c.timeouts

    @property
    def shard_stats(self) -> List[BrokerStats]:
        """Per-shard stats.  Without resilience these are the live broker
        objects; with it, copies merged with the shard's cluster-side
        resilience counters (mirroring the aggregate's accounting)."""
        if self._health is None:
            return [b.stats for b in self.brokers]
        out = []
        for b, h in zip(self.brokers, self._health):
            s = dataclasses.replace(b.stats)
            self._merge_resilience(s, h)
            out.append(s)
        return out

    @property
    def dispatch_counts(self) -> dict:
        """Device dispatches summed across every shard's entry points --
        the dispatch-count regression tests pin a fully-hit served batch
        at exactly one per shard touched on the fused-one-call path."""
        agg: dict = {}
        for b in self.brokers:
            for k, v in b.dispatch_counts.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def warmup(self, sizes=()) -> List[int]:
        """AOT-warm every shard broker (:meth:`Broker.warmup`); returns
        the union of shapes warmed this call."""
        warmed: set = set()
        for b in self.brokers:
            warmed.update(b.warmup(sizes))
        return sorted(warmed)

    def flush(self) -> None:
        """Serve queued pipelined work, then apply every shard's pending
        double-buffered value fill."""
        self._drain_pending()
        for b in self.brokers:
            b.flush()

    # -- fault tolerance ---------------------------------------------------

    def save(self, ckpt_dir: str, step: int) -> str:
        """Per-shard broker checkpoints under one spec-bearing manifest.

        The manifest (which records ``step``) is written *after* every
        shard saved: a crash mid-save leaves the previous manifest
        pointing at the last step all shards completed, so
        ``restore(step=None)`` still finds a consistent checkpoint.
        """
        self._drain_pending()  # a checkpoint cuts at a batch boundary
        os.makedirs(ckpt_dir, exist_ok=True)
        for i, broker in enumerate(self.brokers):
            broker.save(_shard_dir(ckpt_dir, i), step)
        manifest = {
            "version": 1,
            "step": int(step),
            "shards": len(self.brokers),
            "serving_spec": json.loads(self.spec.to_json()),
        }
        fd, tmp = tempfile.mkstemp(dir=ckpt_dir, prefix=".tmp_manifest_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f, sort_keys=True)
            os.replace(tmp, os.path.join(ckpt_dir, MANIFEST_NAME))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        # a freshly saved checkpoint is where a down shard warm-restarts
        self._recovery_dir = ckpt_dir
        return ckpt_dir

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Restore every shard; verify the manifest *first* so a wrong
        deployment reports as such, never as a cache shape mismatch."""
        self._drain_pending()  # queued work belongs to the state being replaced
        path = os.path.join(ckpt_dir, MANIFEST_NAME)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no cluster manifest ({MANIFEST_NAME}) in {ckpt_dir}")
        with open(path) as f:
            manifest = json.load(f)
        saved_shards = int(manifest["shards"])
        if saved_shards != len(self.brokers):
            raise ValueError(
                f"cluster checkpoint was saved with {saved_shards} shards but "
                f"this cluster has {len(self.brokers)}; rebuild the cluster "
                "from the checkpoint's ServingSpec to restore it"
            )
        saved = ServingSpec.from_json(json.dumps(manifest["serving_spec"]))
        if saved != self.spec:
            raise ValueError(
                "cluster checkpoint was produced under a different "
                f"ServingSpec: {saved.to_json()} != {self.spec.to_json()}"
            )
        if step is None:
            # the manifest's step is the last one every shard completed
            step = int(manifest["step"])
        steps = [
            broker.restore(_shard_dir(ckpt_dir, i), step)
            for i, broker in enumerate(self.brokers)
        ]
        if len(set(steps)) != 1:
            raise ValueError(f"shard checkpoints disagree on the step: {steps}")
        self._recovery_dir = ckpt_dir
        return steps[0]

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Shut down the scatter-gather pool and every shard broker.
        Idempotent; ``serve`` after close raises ``RuntimeError``."""
        if self._closed:
            return
        self._drain_pending()  # queued futures complete before shutdown
        for broker in self.brokers:
            broker.close()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __len__(self) -> int:
        return len(self.brokers)


__all__ = ["Cluster", "ClusterFuture", "MANIFEST_NAME"]
