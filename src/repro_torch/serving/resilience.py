"""Resilient shard dispatch: timeout/retry/backoff + a health state machine.

A copy of ``repro.serving.resilience`` (numpy only).  Multi-shard serving
makes partial failure the common case: one slow, crashed, or corrupt shard
must never take the whole cluster's availability with it.  Any query can
bypass its cache shard and miss through to the backend with *identical
results*, paying only latency and hit rate, so this layer's job is
bookkeeping, not correctness:

* :class:`ResilienceSpec` -- the declarative policy (JSON round-trippable
  and embedded in :class:`~repro_torch.serving.spec.ServingSpec`):
  dispatch timeout, bounded retries with exponential backoff and *seeded*
  jitter (bit-deterministic given the spec), health thresholds,
  circuit-breaker probe cadence, and the failover policy.
* :class:`ShardHealth` -- the per-shard state machine a cluster's dispatch
  drives::

      healthy --(suspect_after consecutive failures)--> suspect
      suspect --(down_after consecutive failures)-----> down
      down    --(probe succeeds after recovery)-------> recovering
      recovering --(recover_after successes)----------> healthy
      recovering --(any failure)----------------------> down

  While *down*, the circuit is open: queries route straight to degraded
  miss-through and the shard is only re-probed every
  ``probe_interval_s``.  Every transition is recorded with its timestamp,
  so outage windows and recovery times are measurable
  (:meth:`ShardHealth.down_spans`).

The dispatch loop that drives them is the sharded cluster's
(:class:`repro_torch.serving.cluster.Cluster`).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

#: shard health states, in failure order
HEALTHY = "healthy"
SUSPECT = "suspect"
DOWN = "down"
RECOVERING = "recovering"

_FAILOVERS = ("miss_through", "fail")


@dataclass(frozen=True)
class ResilienceSpec:
    """Declarative fault handling for sharded dispatch (JSON round-trip).

    ``timeout_us``       -- a shard serve slower than this counts as a
                            *timeout failure* for the health machine (its
                            completed result is still used -- the serving
                            state is single-writer, so a late result is
                            never discarded mid-flight; protection against
                            a persistently slow shard comes from the
                            circuit opening, after which batches skip the
                            shard entirely).  0 disables the check.
    ``max_retries``      -- failed dispatch attempts are retried at most
                            this many times before failing over.
    ``backoff_base_us`` / ``backoff_mult`` / ``backoff_cap_us`` --
                            exponential backoff between retries:
                            ``base * mult**attempt`` microseconds, capped.
    ``backoff_jitter``   -- multiplicative jitter fraction: each delay is
                            scaled by ``1 + jitter * u`` with ``u`` drawn
                            from a generator seeded by ``(seed, shard,
                            dispatch_seq, attempt)`` -- bit-deterministic,
                            replayable, and decorrelated across shards.
    ``suspect_after`` / ``down_after`` -- consecutive-failure thresholds
                            of the health state machine.
    ``probe_interval_s`` -- circuit-breaker re-probe cadence while down.
    ``recover_after``    -- consecutive probe successes needed to leave
                            ``recovering`` for ``healthy``.
    ``failover``         -- what happens when retries are exhausted (or
                            the circuit is open): ``"miss_through"``
                            serves the slice straight from the backend in
                            arrival order (identical values, no cache),
                            ``"fail"`` re-raises -- the pre-resilience
                            behaviour.
    """

    timeout_us: float = 0.0
    max_retries: int = 2
    backoff_base_us: float = 200.0
    backoff_mult: float = 2.0
    backoff_cap_us: float = 10_000.0
    backoff_jitter: float = 0.1
    seed: int = 0
    suspect_after: int = 1
    down_after: int = 3
    probe_interval_s: float = 0.05
    recover_after: int = 1
    failover: str = "miss_through"  # "miss_through" | "fail"

    def __post_init__(self):
        for f in ("timeout_us", "backoff_base_us", "backoff_mult",
                  "backoff_cap_us", "backoff_jitter", "probe_interval_s"):
            object.__setattr__(self, f, float(getattr(self, f)))
        for f in ("max_retries", "seed", "suspect_after", "down_after",
                  "recover_after"):
            object.__setattr__(self, f, int(getattr(self, f)))
        if self.timeout_us < 0:
            raise ValueError(f"timeout_us must be >= 0, got {self.timeout_us}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base_us < 0 or self.backoff_cap_us < 0:
            raise ValueError("backoff delays must be >= 0")
        if self.backoff_mult < 1.0:
            raise ValueError(f"backoff_mult must be >= 1, got {self.backoff_mult}")
        if self.backoff_jitter < 0:
            raise ValueError(f"backoff_jitter must be >= 0, got {self.backoff_jitter}")
        if self.suspect_after < 1 or self.down_after < 1:
            raise ValueError("health thresholds must be >= 1")
        if self.down_after < self.suspect_after:
            raise ValueError(
                f"down_after ({self.down_after}) must be >= suspect_after "
                f"({self.suspect_after})"
            )
        if self.probe_interval_s <= 0:
            raise ValueError(
                f"probe_interval_s must be > 0, got {self.probe_interval_s}"
            )
        if self.recover_after < 1:
            raise ValueError(f"recover_after must be >= 1, got {self.recover_after}")
        if self.failover not in _FAILOVERS:
            raise ValueError(
                f"failover must be one of {_FAILOVERS}, got {self.failover!r}"
            )

    # -- serialization ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ResilienceSpec":
        return cls(**json.loads(s))

    # -- backoff ---------------------------------------------------------

    def backoff_s(self, shard: int, seq: int, attempt: int) -> float:
        """Seeded backoff delay (seconds) before retry ``attempt`` of
        dispatch ``seq`` on ``shard``.  Pure function of the spec and its
        arguments -- two runs of the same schedule back off identically."""
        d = self.backoff_base_us * (self.backoff_mult ** attempt)
        if self.backoff_cap_us > 0:
            d = min(d, self.backoff_cap_us)
        if self.backoff_jitter > 0:
            u = np.random.default_rng(
                (self.seed, int(shard), int(seq), int(attempt))
            ).random()
            d *= 1.0 + self.backoff_jitter * float(u)
        return d * 1e-6


@dataclass
class ResilienceCounters:
    """Per-shard dispatch accounting, kept cluster-side so a shard's
    restart (which restores the *broker's* checkpointed stats) never
    loses the outage's bookkeeping."""

    #: requests served by degraded miss-through (cache bypassed)
    degraded: int = 0
    #: backend calls made by degraded miss-through
    degraded_calls: int = 0
    #: dispatch attempts retried after a failure
    retried: int = 0
    #: requests that exhausted retries and failed over mid-dispatch
    failed_over: int = 0
    #: completed serves slower than the spec's timeout
    timeouts: int = 0
    #: dispatch failures observed (raised errors + timeouts)
    failures: int = 0
    #: circuit-breaker probes attempted while down
    probes: int = 0
    #: warm restarts completed (checkpoint-restored or cold)
    recoveries: int = 0


class ShardHealth:
    """One shard's health state machine + transition log.

    Driven by the cluster's dispatch (``record_success`` /
    ``record_failure``); every transition is appended to ``events`` as
    ``(t, state)`` so outages are measurable after the fact.
    """

    def __init__(self, spec: ResilienceSpec):
        self.spec = spec
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.probe_successes = 0
        self.next_probe_t: Optional[float] = None
        self.events: List[Tuple[float, str]] = []
        self.counters = ResilienceCounters()

    def _to(self, now: float, state: str) -> None:
        self.state = state
        self.events.append((float(now), state))

    # -- dispatch feedback ----------------------------------------------

    def record_success(self, now: float) -> None:
        self.consecutive_failures = 0
        if self.state == SUSPECT:
            self._to(now, HEALTHY)
        elif self.state == RECOVERING:
            self.probe_successes += 1
            if self.probe_successes >= self.spec.recover_after:
                self._to(now, HEALTHY)

    def record_failure(self, now: float) -> None:
        self.counters.failures += 1
        self.consecutive_failures += 1
        if self.state == RECOVERING:
            self.mark_down(now)
            return
        if (
            self.state == HEALTHY
            and self.consecutive_failures >= self.spec.suspect_after
        ):
            self._to(now, SUSPECT)
        if (
            self.state == SUSPECT
            and self.consecutive_failures >= self.spec.down_after
        ):
            self.mark_down(now)

    # -- circuit breaker -------------------------------------------------

    def mark_down(self, now: float) -> None:
        if self.state != DOWN:
            self._to(now, DOWN)
        self.probe_successes = 0
        self.next_probe_t = float(now) + self.spec.probe_interval_s

    def probe_due(self, now: float) -> bool:
        return self.state == DOWN and (
            self.next_probe_t is None or float(now) >= self.next_probe_t
        )

    def probe_failed(self, now: float) -> None:
        """A re-probe (or the recovery preceding it) failed: stay down
        and push the next probe out one interval."""
        self.next_probe_t = float(now) + self.spec.probe_interval_s

    def begin_recovery(self, now: float) -> None:
        """The shard restarted (checkpoint-restored or cold): serve it
        again, but treat it as convalescent until ``recover_after``
        consecutive successes."""
        self.probe_successes = 0
        self.consecutive_failures = 0
        self._to(now, RECOVERING)

    # -- measurement -----------------------------------------------------

    def down_spans(self) -> List[Tuple[float, Optional[float]]]:
        """Outage windows as ``(down_at, healthy_at)`` pairs; an open
        outage has ``healthy_at=None``.  Recovery time is their width."""
        spans: List[Tuple[float, Optional[float]]] = []
        start: Optional[float] = None
        for t, s in self.events:
            if s == DOWN and start is None:
                start = t
            elif s == HEALTHY and start is not None:
                spans.append((start, t))
                start = None
        if start is not None:
            spans.append((start, None))
        return spans


__all__ = [
    "DOWN",
    "HEALTHY",
    "RECOVERING",
    "SUSPECT",
    "ResilienceCounters",
    "ResilienceSpec",
    "ShardHealth",
]
