"""Seeded arrival processes: virtual-time timestamps for open-loop load
(port of ``repro.loadgen.arrivals``, numpy only: the same spec gives the
same timestamps bit for bit).

A result cache is judged on what a *user* experiences under an arrival
process, not on the throughput of a back-to-back loop.  This module
turns the synthetic key streams (``repro_torch.querylog.synth`` Zipf
and drift logs) into open-loop workloads by stamping each request with a
virtual-time arrival timestamp drawn from a seeded process:

* ``"poisson"``       -- memoryless arrivals at a mean rate (the
                         continuous-time request process of Gao et al.);
* ``"onoff"``         -- a 2-state MMPP: exponentially-distributed ON
                         sojourns at ``burst`` times the mean rate
                         alternate with quiet OFF sojourns, calibrated
                         so the long-run rate is exactly ``rate`` --
                         bursty traffic that stresses tail latency and
                         the bounded queue;
* ``"deterministic"`` -- evenly spaced arrivals (a closed-form control).

Everything is deterministic given the spec (process, rate, seed):
the same spec always produces the same timestamps, which is what makes
the open-loop harness's queueing decisions replayable.

Multi-tenant mixes: :func:`stamp_arrivals` tags a key stream with a
tenant id and :func:`merge_workloads` interleaves several tenants'
streams into one time-ordered workload (stable tie-break: earlier
tenant first), so several ``CacheSpec`` strategies can share one
open-loop timeline.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

_PROCESSES = ("poisson", "onoff", "deterministic")


@dataclass(frozen=True)
class ArrivalSpec:
    """One seeded arrival process (JSON round-trippable).

    ``rate`` is the long-run mean arrival rate in requests per virtual
    second for every process.  The on-off process is parameterized by
    the ON-state rate multiplier ``burst`` (``rate_on = burst * rate``),
    the long-run fraction of time spent ON (``on_frac``) and the mean ON
    sojourn (``mean_on_s``); the OFF rate is derived so the mixture's
    mean is exactly ``rate``, which requires ``burst * on_frac <= 1``.
    """

    process: str = "poisson"  # "poisson" | "onoff" | "deterministic"
    rate: float = 50_000.0
    burst: float = 4.0
    on_frac: float = 0.2
    mean_on_s: float = 0.02
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "rate", float(self.rate))
        object.__setattr__(self, "burst", float(self.burst))
        object.__setattr__(self, "on_frac", float(self.on_frac))
        object.__setattr__(self, "mean_on_s", float(self.mean_on_s))
        object.__setattr__(self, "seed", int(self.seed))
        if self.process not in _PROCESSES:
            raise ValueError(
                f"process must be one of {_PROCESSES}, got {self.process!r}"
            )
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.process == "onoff":
            if self.burst < 1.0:
                raise ValueError(f"onoff burst must be >= 1, got {self.burst}")
            if not 0.0 < self.on_frac < 1.0:
                raise ValueError(f"on_frac must be in (0, 1), got {self.on_frac}")
            if self.burst * self.on_frac > 1.0 + 1e-12:
                raise ValueError(
                    "onoff needs burst * on_frac <= 1 (otherwise the OFF rate "
                    f"would be negative): got {self.burst} * {self.on_frac}"
                )
            if self.mean_on_s <= 0:
                raise ValueError(f"mean_on_s must be > 0, got {self.mean_on_s}")

    # -- serialization ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ArrivalSpec":
        return cls(**json.loads(s))

    # -- generation ------------------------------------------------------

    def times(self, n: int) -> np.ndarray:
        """``n`` nondecreasing arrival timestamps (virtual seconds,
        float64, starting after 0).  Deterministic in the spec."""
        if n <= 0:
            return np.zeros(0, np.float64)
        rng = np.random.default_rng(self.seed)
        if self.process == "deterministic":
            return (np.arange(1, n + 1, dtype=np.float64)) / self.rate
        if self.process == "poisson":
            return np.cumsum(rng.exponential(1.0 / self.rate, size=n))
        return self._onoff_times(rng, n)

    def _onoff_times(self, rng: np.random.Generator, n: int) -> np.ndarray:
        rate_on = self.rate * self.burst
        rate_off = self.rate * (1.0 - self.burst * self.on_frac) / (1.0 - self.on_frac)
        mean_off = self.mean_on_s * (1.0 - self.on_frac) / self.on_frac
        out: List[np.ndarray] = []
        remaining = n
        t = 0.0
        on = bool(rng.random() < self.on_frac)
        while remaining > 0:
            dur = float(rng.exponential(self.mean_on_s if on else mean_off))
            r = rate_on if on else rate_off
            if r > 0 and dur > 0:
                # conditioned on the count, Poisson arrival times in a
                # window are iid uniform -- exact, and vectorized
                k = min(int(rng.poisson(r * dur)), remaining)
                if k:
                    out.append(t + np.sort(rng.random(k)) * dur)
                    remaining -= k
            t += dur
            on = not on
        return np.concatenate(out)


@dataclass
class Workload:
    """A key stream stamped with arrival times (and tenant tags).

    ``keys`` and ``t`` are parallel arrays sorted by nondecreasing ``t``;
    ``tenant`` is the dense tenant id of every request (all zero for a
    single-tenant workload).
    """

    keys: np.ndarray  # (n,) int64 query ids
    t: np.ndarray  # (n,) float64 virtual arrival seconds, nondecreasing
    tenant: np.ndarray  # (n,) int32 tenant ids in [0, n_tenants)
    n_tenants: int = 1

    def __post_init__(self):
        self.keys = np.asarray(self.keys, np.int64)
        self.t = np.asarray(self.t, np.float64)
        self.tenant = np.asarray(self.tenant, np.int32)
        if not (len(self.keys) == len(self.t) == len(self.tenant)):
            raise ValueError("keys, t and tenant must be parallel arrays")
        if len(self.t) and np.any(np.diff(self.t) < 0):
            raise ValueError("arrival timestamps must be nondecreasing")

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def duration_s(self) -> float:
        return float(self.t[-1]) if len(self.t) else 0.0

    @property
    def offered_rps(self) -> float:
        return len(self) / self.duration_s if self.duration_s > 0 else 0.0


def stamp_arrivals(
    keys: np.ndarray, spec: ArrivalSpec, tenant: int = 0
) -> Workload:
    """Stamp a key stream (e.g. ``SynthLog.keys`` or a drift stream's
    test slice) with arrival times from ``spec``.  Key order is
    preserved, so the stream's temporal structure -- Zipf head rotation,
    drift phase boundaries -- maps onto virtual time proportionally."""
    keys = np.asarray(keys, np.int64)
    t = spec.times(len(keys))
    return Workload(
        keys=keys,
        t=t,
        tenant=np.full(len(keys), int(tenant), np.int32),
        n_tenants=int(tenant) + 1,
    )


def merge_workloads(workloads: Sequence[Workload]) -> Workload:
    """Interleave tenant workloads into one time-ordered stream.

    Tenant ids are re-assigned densely in argument order; at equal
    timestamps the earlier-listed tenant's request comes first (stable),
    and each tenant's own request order is preserved -- so the merge is
    deterministic and per-tenant semantics are unchanged.
    """
    if not workloads:
        raise ValueError("merge_workloads needs at least one workload")
    keys = np.concatenate([w.keys for w in workloads])
    t = np.concatenate([w.t for w in workloads])
    tenant = np.concatenate(
        [np.full(len(w), i, np.int32) for i, w in enumerate(workloads)]
    )
    order = np.argsort(t, kind="stable")
    return Workload(
        keys=keys[order], t=t[order], tenant=tenant[order],
        n_tenants=len(workloads),
    )


__all__ = ["ArrivalSpec", "Workload", "merge_workloads", "stamp_arrivals"]
