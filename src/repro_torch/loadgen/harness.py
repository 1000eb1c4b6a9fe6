"""Virtual-clock open-loop driver: arrivals -> batches -> a real server
(port of ``repro.loadgen.harness``; the planner is the reference's numpy
code, so one workload and policy give the same plan in both packages).

The harness separates the two clocks a load test conflates:

* **Virtual time** drives every *decision*.  Requests arrive at their
  stamped timestamps; a deterministic single-server model (the
  :class:`~repro_torch.serving.spec.BatchPolicySpec` provisioned service
  model) advances a model ``server_free`` clock; batches close by
  deadline-driven coalescing; a bounded pending queue sheds or defers
  overflow.  Given the same workload and policy, the batch formation
  and the shed set are **bit-identical across runs and machines** --
  wall-clock never enters a decision.
* **Wall-clock** is only *measured*: every planned batch is served
  through a real :class:`~repro_torch.serving.broker.Broker` or
  :class:`~repro_torch.serving.cluster.Cluster` and its service time
  recorded.  A serve returns the batch's values as host arrays, copied
  back from the card, so the clock stops after the batch's device work.

Per-request latency is attributed as ``queueing + service``: the
queueing component (``dispatch_time - arrival``) comes from the
deterministic virtual timeline, the service component is the measured
wall time of the request's batch.  Percentiles over that sum are what
``SLOSpec`` judges.

Batch formation (single server, per-tenant pending queues):

* a batch *closes* at the earliest virtual time one of these holds with
  the model server free:

  - **full**: ``max_batch`` requests are pending -- the batch snaps
    *down* to the serving tier's ``BucketSpec`` boundary
    (``snap_to_bucket``), so saturated traffic is served in exactly
    pre-compiled shapes with zero pad overhead;
  - **deadline**: the oldest pending request has waited
    ``deadline_us`` -- everything pending (up to ``max_batch``) flushes,
    and the broker pads the ragged remainder up to its bucket;
  - **drain**: no arrivals remain -- flush immediately.

* arrivals past ``max_queue`` pending are **shed** (dropped, counted)
  or **deferred** (admitted but counted) per ``overflow``.
* with several tenants, each tenant has its own pending queue and
  policy but the model server is shared: the tenant whose close
  condition fires earliest dispatches (deterministic tie-break by
  tenant index), so a 2-tenant strategy mix contends for real capacity.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..serving.broker import Broker, BrokerStats
from ..serving.cluster import Cluster
from ..serving.spec import BatchPolicySpec, BucketSpec
from .arrivals import Workload

Server = Union[Broker, Cluster]

_INF = float("inf")


def snap_down(bucket: Optional[BucketSpec], k: int) -> int:
    """The largest bucket boundary <= ``k`` (``k`` itself when no bucket
    applies, or when ``k`` is below the smallest bucket -- the server
    pads such a batch *up*, which costs less than holding requests)."""
    if bucket is None or not bucket.enabled or k <= 0:
        return k
    if bucket.mode == "explicit":
        below = [s for s in bucket.sizes if s <= k]
        return below[-1] if below else k
    if k < bucket.min_size:
        return k
    return 1 << (int(k).bit_length() - 1)


@dataclass(frozen=True)
class PlannedBatch:
    tenant: int
    idx: np.ndarray  # workload indices, arrival order
    t_dispatch: float  # virtual seconds the batch starts service
    reason: str  # "full" | "deadline" | "drain"
    padded: int  # model/bucket padded length the server will run


@dataclass
class LoadPlan:
    """Deterministic queueing decisions for one workload + policy."""

    batches: List[PlannedBatch]
    shed: np.ndarray  # workload indices dropped at admission
    deferred: np.ndarray  # indices admitted past max_queue (overflow="defer")
    queue_delay_s: np.ndarray  # (n,) virtual queueing delay; NaN for shed
    makespan_s: float  # virtual time the model server went idle

    @property
    def n(self) -> int:
        return len(self.queue_delay_s)

    @property
    def served(self) -> int:
        return self.n - len(self.shed)

    @property
    def pad_slots(self) -> int:
        """Device-batch slots the plan spends on padding (the coalescing
        policy's padding debt under the static-shape contract)."""
        return sum(b.padded - len(b.idx) for b in self.batches)

    @property
    def pad_overhead(self) -> float:
        slots = sum(b.padded for b in self.batches)
        return self.pad_slots / slots if slots else 0.0

    def signature(self) -> Tuple:
        """Hashable summary of every queueing decision -- two plans with
        equal signatures made identical batch formation and shed
        choices (the determinism contract the tests pin)."""
        return (
            tuple(
                (b.tenant, tuple(int(i) for i in b.idx), round(b.t_dispatch, 12), b.reason)
                for b in self.batches
            ),
            tuple(int(i) for i in self.shed),
            tuple(int(i) for i in self.deferred),
        )


def _as_list(x, n_tenants: int, name: str) -> List:
    if isinstance(x, (list, tuple)):
        if len(x) != n_tenants:
            raise ValueError(
                f"{name}: got {len(x)} entries for {n_tenants} tenants"
            )
        return list(x)
    return [x] * n_tenants


def plan_batches(
    workload: Workload,
    policy: Union[BatchPolicySpec, Sequence[BatchPolicySpec]],
    bucket: Union[BucketSpec, Sequence[Optional[BucketSpec]], None] = None,
) -> LoadPlan:
    """Form batches from the arrival timeline under the policy.

    Pure virtual-time simulation -- no serving happens here, so the
    returned plan is deterministic in its inputs and can be inspected,
    replayed, or executed (:func:`run_open_loop`) any number of times.
    ``policy``/``bucket`` accept one value shared by every tenant or a
    per-tenant sequence.
    """
    n = len(workload)
    n_t = workload.n_tenants
    pols: List[BatchPolicySpec] = _as_list(policy, n_t, "policy")
    buckets = _as_list(bucket if bucket is not None else BucketSpec(), n_t, "bucket")
    t = workload.t
    tenant = workload.tenant

    pend: List[List[int]] = [[] for _ in range(n_t)]
    head = [0] * n_t
    server_free = 0.0
    i = 0
    batches: List[PlannedBatch] = []
    shed: List[int] = []
    deferred: List[int] = []
    queue_delay = np.full(n, np.nan)

    def plen(k: int) -> int:
        return len(pend[k]) - head[k]

    def next_dispatch(k: int) -> Tuple[float, str]:
        m = plen(k)
        if m == 0:
            return _INF, ""
        pol = pols[k]
        q = pend[k]
        h = head[k]
        best_t = max(server_free, t[q[h]] + pol.deadline_us * 1e-6)
        reason = "deadline"
        if m >= pol.max_batch:
            t_full = max(server_free, t[q[h + pol.max_batch - 1]])
            if t_full < best_t:
                best_t, reason = t_full, "full"
        if i >= n:
            t_drain = max(server_free, t[q[-1]])
            if t_drain < best_t:
                best_t, reason = t_drain, "drain"
        return best_t, reason

    while i < n or any(plen(k) for k in range(n_t)):
        best_t, best_r, best_k = _INF, "", -1
        for k in range(n_t):
            tk, rk = next_dispatch(k)
            if tk < best_t:
                best_t, best_r, best_k = tk, rk, k
        if i < n and t[i] < best_t:
            # the next arrival happens before any batch can close: admit
            # it (or shed/defer past the bound) and re-evaluate
            k = int(tenant[i])
            if plen(k) >= pols[k].max_queue:
                if pols[k].overflow == "shed":
                    shed.append(i)
                    i += 1
                    continue
                deferred.append(i)
            pend[k].append(i)
            i += 1
            continue
        pol = pols[best_k]
        take = min(plen(best_k), pol.max_batch)
        if best_r == "full" and pol.snap_to_bucket:
            take = snap_down(buckets[best_k], take)
        h = head[best_k]
        idx = np.asarray(pend[best_k][h : h + take], np.int64)
        head[best_k] = h + take
        if head[best_k] > 65536:  # compact the drained prefix
            pend[best_k] = pend[best_k][head[best_k]:]
            head[best_k] = 0
        queue_delay[idx] = best_t - t[idx]
        bk = buckets[best_k]
        padded = bk.padded_len(take) if bk is not None and bk.enabled else take
        batches.append(
            PlannedBatch(
                tenant=best_k, idx=idx, t_dispatch=best_t, reason=best_r,
                padded=padded,
            )
        )
        server_free = best_t + pol.service_cost_s(padded)

    return LoadPlan(
        batches=batches,
        shed=np.asarray(shed, np.int64),
        deferred=np.asarray(deferred, np.int64),
        queue_delay_s=queue_delay,
        makespan_s=server_free,
    )


# ---------------------------------------------------------------------------
# execution against a real server
# ---------------------------------------------------------------------------


@dataclass
class LoadReport:
    """What the user experienced: latency percentiles + accounting."""

    n: int
    served: int
    shed: int
    deferred: int
    shed_rate: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    p999_ms: float
    mean_ms: float
    queue_p99_ms: float  # the deterministic queueing component alone
    offered_rps: float  # arrival rate over the workload's span
    achieved_rps: float  # served requests over the virtual makespan
    service_rps: float  # served requests over measured wall service time
    pad_overhead: float  # planner pad slots / total device-batch slots
    hit_rate: float
    per_tenant: List[dict] = field(default_factory=list)

    def to_derived(self) -> str:
        """``k=v;...`` string in the benchmark runner's row format."""
        parts = [
            f"p50_ms={self.p50_ms:.3f}",
            f"p90_ms={self.p90_ms:.3f}",
            f"p99_ms={self.p99_ms:.3f}",
            f"p999_ms={self.p999_ms:.3f}",
            f"shed_rate={self.shed_rate:.4f}",
            f"throughput_rps={self.achieved_rps:.0f}",
            f"service_rps={self.service_rps:.0f}",
            f"offered_rps={self.offered_rps:.0f}",
            f"pad_overhead={self.pad_overhead:.4f}",
            f"hit_rate={self.hit_rate:.4f}",
        ]
        return ";".join(parts)


@dataclass
class LoadResult:
    """One executed open-loop run: the plan plus measured latencies."""

    workload: Workload
    plan: LoadPlan
    queue_s: np.ndarray  # (n,) deterministic queueing delay (NaN = shed)
    service_s: np.ndarray  # (n,) measured wall service of the request's batch
    wall_serve_s: float  # total measured service wall time
    stats: List[BrokerStats]  # per-tenant server stats (post-run)
    #: with ``collect=True``: per-request served values (zeros for shed
    #: requests) and hit mask -- what availability checks compare to a
    #: backend oracle
    values: Optional[np.ndarray] = None
    hit: Optional[np.ndarray] = None

    @property
    def latency_s(self) -> np.ndarray:
        return self.queue_s + self.service_s

    def report(self) -> LoadReport:
        served_mask = ~np.isnan(self.queue_s)
        lat_ms = self.latency_s[served_mask] * 1e3
        q_ms = self.queue_s[served_mask] * 1e3
        n = len(self.workload)
        served = int(served_mask.sum())
        if served:
            p50, p90, p99, p999 = np.percentile(lat_ms, [50, 90, 99, 99.9])
            mean = float(lat_ms.mean())
            q99 = float(np.percentile(q_ms, 99))
        else:
            p50 = p90 = p99 = p999 = mean = q99 = float("nan")
        requests = sum(s.requests for s in self.stats)
        hits = sum(s.hits for s in self.stats)
        per_tenant = []
        if self.workload.n_tenants > 1:
            for k in range(self.workload.n_tenants):
                sel = served_mask & (self.workload.tenant == k)
                t_lat = self.latency_s[sel] * 1e3
                s = self.stats[k] if k < len(self.stats) else BrokerStats()
                per_tenant.append(
                    {
                        "tenant": k,
                        "served": int(sel.sum()),
                        "p50_ms": float(np.percentile(t_lat, 50)) if sel.any() else float("nan"),
                        "p99_ms": float(np.percentile(t_lat, 99)) if sel.any() else float("nan"),
                        "hit_rate": s.hit_rate,
                    }
                )
        return LoadReport(
            n=n,
            served=served,
            shed=len(self.plan.shed),
            deferred=len(self.plan.deferred),
            shed_rate=len(self.plan.shed) / n if n else 0.0,
            p50_ms=float(p50),
            p90_ms=float(p90),
            p99_ms=float(p99),
            p999_ms=float(p999),
            mean_ms=mean,
            queue_p99_ms=q99,
            offered_rps=self.workload.offered_rps,
            achieved_rps=served / self.plan.makespan_s if self.plan.makespan_s > 0 else 0.0,
            service_rps=served / self.wall_serve_s if self.wall_serve_s > 0 else 0.0,
            pad_overhead=self.plan.pad_overhead,
            hit_rate=hits / requests if requests else 0.0,
            per_tenant=per_tenant,
        )


def _server_bucket(server: Server) -> Optional[BucketSpec]:
    if isinstance(server, Cluster):
        return server.brokers[0].bucket if server.brokers else None
    return server.bucket


def _server_brokers(server: Server) -> List[Broker]:
    return list(server.brokers) if isinstance(server, Cluster) else [server]


def _reset_stats(server: Server) -> None:
    """Zero a server's scalar counters in place (keeps the tracker's
    ``topic_counts`` array shared) -- run after warmup so the reported
    stats cover only the measured stream."""
    for b in _server_brokers(server):
        fresh = BrokerStats()
        for f in (
            "requests", "hits", "static_hits", "topic_hits", "backend_calls",
            "hedged_calls", "admitted", "coalesced", "padded", "batches",
            "rebalances", "migrated", "degraded", "retried", "failed_over",
            "timeouts", "expired", "stale_served", "revalidations",
            "freshness_violations", "invalidations",
        ):
            setattr(b.stats, f, getattr(fresh, f))


def warmup_server(server: Server, sizes: Sequence[int], pad_key: int = -1) -> None:
    """Warm a server for the batch sizes a plan will serve, without
    touching cache state: delegates to ``Broker.warmup``, which builds the
    kernels and calls every serving entry point on all-pad batches (pads
    never hit, are never admitted, never write) and discards the outputs,
    so the only side effects are the build and stats -- which are reset.

    Host-engine servers build nothing, so ``Broker.warmup`` is a no-op
    there (the backend never sees the warmup's pad ids).  For a cluster,
    each shard broker is warmed directly: routing would send every pad
    to one shard (they share one hash), while real batches split across
    shards into bucket-padded slices.
    """
    sizes = sorted(set(int(s) for s in sizes if int(s) > 0))
    for b in _server_brokers(server):
        b.warmup(sizes)
    server.flush()
    _reset_stats(server)


def run_open_loop(
    workload: Workload,
    servers: Union[Server, Sequence[Server]],
    policy: Union[BatchPolicySpec, Sequence[BatchPolicySpec]],
    bucket: Union[BucketSpec, Sequence[Optional[BucketSpec]], None] = None,
    plan: Optional[LoadPlan] = None,
    warmup: bool = True,
    clock: Callable[[], float] = time.perf_counter,
    collect: bool = False,
    invalidations=None,
    pipeline: Optional[int] = None,
) -> LoadResult:
    """Plan batches in virtual time, then serve them for real.

    ``servers`` is one ``Broker``/``Cluster`` per tenant (or a single
    shared server for single-tenant workloads).  When ``bucket`` is not
    given it is taken from each tenant's server, so the planner snaps to
    exactly the shapes the server compiles.  ``warmup`` serves one
    all-pad batch per planned batch size first (state-inert by the pad
    invariant) and resets stats, so the kernels' build and first launches
    never land in a measured service time.

    Servers exposing ``advance_time`` (a resilient ``Cluster``) have
    their virtual clock driven to each batch's ``t_dispatch`` before it
    serves, so fault schedules, health transitions and circuit-breaker
    probes replay deterministically on the plan's timeline.  With
    ``collect=True`` the served values and hit mask are gathered into
    the result (arrival order; zeros/False for shed requests) for
    availability checks against a backend oracle.

    ``invalidations`` (an
    :class:`repro_torch.querylog.synth.InvalidationStream`, or one per tenant)
    replays invalidation events against each tenant's server in the
    same virtual time: events due at or before a batch's dispatch time
    land before it serves, so freshness episodes -- like fault
    episodes -- are a deterministic function of the plan and the seeds.

    ``pipeline`` (default off) drives servers exposing ``serve_async``
    -- a :class:`repro_torch.serving.Cluster` with a ``DispatchSpec`` -- in
    groups of up to that many consecutive same-tenant batches: the
    whole group is submitted before any result is drained, so shard
    work fuses across batches.  The group is the measurement unit of a
    steady-state pipeline (like ``reps`` in a throughput bench), so its
    measured wall time is amortized over the group's requests and each
    batch's service time is its request-weighted share -- the
    steady-state residence time of a batch inside the pipeline.
    ``wall_serve_s`` still accumulates each group's wall time once, so
    throughput numbers stay unamortized.  The virtual clock and
    invalidation streams advance to the *last* batch's ``t_dispatch``
    before the group serves: queued batches serve at submission time,
    so events up to the flush land first, exactly like a deadline-held
    batch.  Servers without ``serve_async`` fall back to the per-batch
    synchronous loop.
    """
    srv = _as_list(servers, workload.n_tenants, "servers")
    buckets = (
        [_server_bucket(s) for s in srv]
        if bucket is None
        else _as_list(bucket, workload.n_tenants, "bucket")
    )
    if plan is None:
        plan = plan_batches(workload, policy, bucket=buckets)
    if warmup:
        for k, s in enumerate(srv):
            sizes = {len(b.idx) for b in plan.batches if b.tenant == k}
            warmup_server(s, sizes)
    invals = (
        [None] * workload.n_tenants
        if invalidations is None
        else _as_list(invalidations, workload.n_tenants, "invalidations")
    )

    n = len(workload)
    service = np.full(n, np.nan)
    wall = 0.0
    values: Optional[np.ndarray] = None
    hit: Optional[np.ndarray] = None
    pipe = max(1, int(pipeline)) if pipeline else 1
    batches = plan.batches
    i = 0
    while i < len(batches):
        batch = batches[i]
        server = srv[batch.tenant]
        group = [batch]
        if pipe > 1 and hasattr(server, "serve_async"):
            while (
                len(group) < pipe
                and i + len(group) < len(batches)
                and batches[i + len(group)].tenant == batch.tenant
            ):
                group.append(batches[i + len(group)])
        i += len(group)
        t_dispatch = group[-1].t_dispatch
        advance = getattr(server, "advance_time", None)
        if advance is not None:
            advance(t_dispatch)
        stream = invals[batch.tenant]
        if stream is not None:
            stream.apply(server, t_dispatch)
        if len(group) == 1:
            t0 = clock()
            outs = [server.serve(workload.keys[batch.idx])]
            dt = clock() - t0
        else:
            t0 = clock()
            futs = [server.serve_async(workload.keys[b.idx]) for b in group]
            outs = [f.result() for f in futs]
            dt = clock() - t0
        wall += dt
        n_served = sum(len(b.idx) for b in group)
        for b, (v, h) in zip(group, outs):
            service[b.idx] = (
                dt * (len(b.idx) / n_served) if len(group) > 1 else dt
            )
            if collect:
                if values is None:
                    values = np.zeros((n, np.asarray(v).shape[1]), np.int32)
                    hit = np.zeros(n, bool)
                values[b.idx] = v
                hit[b.idx] = h
    stats = [s.stats for s in srv]
    return LoadResult(
        workload=workload,
        plan=plan,
        queue_s=plan.queue_delay_s.copy(),
        service_s=service,
        wall_serve_s=wall,
        stats=stats,
        values=values,
        hit=hit,
    )


__all__ = [
    "LoadPlan",
    "LoadReport",
    "LoadResult",
    "PlannedBatch",
    "plan_batches",
    "run_open_loop",
    "snap_down",
    "warmup_server",
]
