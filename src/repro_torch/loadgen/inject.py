"""Deterministic fault + latency injection for backends and shards (port
of ``repro.loadgen.inject``, numpy only).

Two instruments, both seeded and JSON round-trippable:

* :class:`LatencyInjectSpec` / :func:`inject_latency` -- wrap a broker
  backend so selected calls sleep for a reproducible delay before
  delegating.  This is how the hedging tests manufacture a straggler:
  the primary backend is wrapped with a large injected delay while the
  hedge replica is left fast.
* :class:`FaultInjectSpec` / :class:`FaultInjector` -- a deterministic
  *schedule of failures* for a cluster shard (or any callable): raised
  errors, injected dispatch timeouts, a permanent crash at a given
  virtual time, and (composably) the latency injection above.  The
  resilience layer (:mod:`repro_torch.serving.resilience`) is exercised by
  attaching an injector to a shard via
  :meth:`repro_torch.serving.cluster.Cluster.inject_shard_faults`; the
  open-loop harness drives the injector's virtual clock batch by batch,
  so a fault episode replays bit-identically
  (``LoadPlan.signature()``-style).

Fault decisions are a pure function of the spec and the call index
(per-call generators seeded by ``(seed, call)``), never of thread
timing, so concurrent shard dispatch cannot perturb the schedule.
:func:`corrupt_checkpoint` completes the menu: it deterministically
tampers with (or truncates) a written checkpoint's array file, which the
manifest checksums of :mod:`repro_torch.train.checkpoint` must catch so
recovery falls back to the previous step instead of loading garbage.

All wrappers are thread-safe (hedged/parallel dispatch calls them from
thread pools) and purely additive: values returned by the inner callable
pass through untouched.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass(frozen=True)
class LatencyInjectSpec:
    """Which calls to delay, and by how much (JSON round-trippable).

    Every ``every``-th call (counting from the first) sleeps
    ``delay_s`` plus a seeded uniform jitter in ``[0, jitter_s)``.
    ``every=1`` delays every call; ``every=3`` delays calls 1, 4, 7, ...
    """

    delay_s: float = 0.2
    every: int = 1
    jitter_s: float = 0.0
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "delay_s", float(self.delay_s))
        object.__setattr__(self, "every", int(self.every))
        object.__setattr__(self, "jitter_s", float(self.jitter_s))
        object.__setattr__(self, "seed", int(self.seed))
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if self.jitter_s < 0:
            raise ValueError(f"jitter_s must be >= 0, got {self.jitter_s}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "LatencyInjectSpec":
        return cls(**json.loads(s))

    def delay_for(self, call: int) -> float:
        """The (seeded) delay of 0-based ``call`` -- pure function, so
        the schedule is identical however calls interleave."""
        if call % self.every != 0:
            return 0.0
        d = self.delay_s
        if self.jitter_s > 0:
            u = np.random.default_rng((self.seed, int(call))).random()
            d += float(u) * self.jitter_s
        return d


class _InjectedBackend:
    """Callable wrapper: sleeps per the spec, then delegates."""

    def __init__(self, backend: Callable, spec: LatencyInjectSpec):
        self._backend = backend
        self._spec = spec
        self._lock = threading.Lock()
        self.calls = 0
        self.delayed = 0

    def __call__(self, keys):
        with self._lock:
            c = self.calls
            self.calls += 1
            delay = self._spec.delay_for(c)
            if c % self._spec.every == 0:  # scheduled, even if delay_s=0
                self.delayed += 1
        if delay > 0:
            time.sleep(delay)
        return self._backend(keys)


def inject_latency(backend: Callable, spec: LatencyInjectSpec) -> _InjectedBackend:
    """Wrap ``backend`` with deterministic injected latency.

    The returned wrapper exposes ``.calls`` and ``.delayed`` counters so
    tests can assert the straggler path was actually exercised.
    """
    return _InjectedBackend(backend, spec)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """Base of every injected failure (never raised directly)."""


class InjectedError(InjectedFault):
    """A transient raised error (models a failed RPC / engine error)."""


class InjectedTimeout(InjectedFault):
    """A dispatch that gave up waiting (models the caller's timeout
    firing; the injector raises instead of sleeping so schedules stay
    fast and deterministic)."""


class InjectedCrash(InjectedFault):
    """A permanent crash: every call fails until :meth:`FaultInjector
    .restart` models the process being replaced."""


@dataclass(frozen=True)
class FaultInjectSpec:
    """A seeded, deterministic schedule of injected faults (JSON
    round-trippable).

    Per 0-based call index ``c`` (and virtual time ``now``):

    * ``error_every``/``error_rate``     -- raise :class:`InjectedError`
      on calls ``c % error_every == 0``, plus a seeded Bernoulli
      ``error_rate`` draw per call (either or both may be active);
    * ``timeout_every``/``timeout_rate`` -- same schedule shape, raising
      :class:`InjectedTimeout`;
    * ``crash_at_s``                     -- the first call at or after
      this virtual time raises :class:`InjectedCrash`, and so does every
      later call until :meth:`FaultInjector.restart` (a one-shot
      *permanent* crash: the restarted replica does not re-crash);
    * ``latency``                        -- an optional composed
      :class:`LatencyInjectSpec` applied (sleep) before the fault
      checks, so slow-and-flaky shards are one spec.

    Rate draws use a generator seeded by ``(seed, c)`` -- a pure
    function of the spec and the call index -- so the schedule is
    bit-identical across runs, machines, and thread interleavings.
    """

    error_every: int = 0
    error_rate: float = 0.0
    timeout_every: int = 0
    timeout_rate: float = 0.0
    crash_at_s: Optional[float] = None
    #: when this shard crashes, also tamper with its newest checkpoint
    #: (applied by the cluster's recovery path via
    #: :func:`corrupt_checkpoint`) -- the torn-write scenario: recovery
    #: must detect it and fall back to the previous step
    corrupt_latest: bool = False
    latency: Optional[LatencyInjectSpec] = None
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "error_every", int(self.error_every))
        object.__setattr__(self, "timeout_every", int(self.timeout_every))
        object.__setattr__(self, "error_rate", float(self.error_rate))
        object.__setattr__(self, "timeout_rate", float(self.timeout_rate))
        object.__setattr__(self, "corrupt_latest", bool(self.corrupt_latest))
        object.__setattr__(self, "seed", int(self.seed))
        if self.crash_at_s is not None:
            object.__setattr__(self, "crash_at_s", float(self.crash_at_s))
        if self.error_every < 0 or self.timeout_every < 0:
            raise ValueError("every-schedules must be >= 0 (0 = off)")
        for f in ("error_rate", "timeout_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FaultInjectSpec":
        d = json.loads(s)
        lat = d.pop("latency", None)
        return cls(
            latency=LatencyInjectSpec(**lat) if lat is not None else None, **d
        )


class FaultInjector:
    """Compiled :class:`FaultInjectSpec`: one shard's fault process.

    ``check(now)`` counts one call and raises per the schedule;
    ``restart()`` models the crashed process being replaced (clears the
    crash latch without re-arming it).  Thread-safe; counters
    (``calls``, ``errors``, ``timeouts``, ``crashed_calls``,
    ``restarts``) let tests assert the schedule actually fired.
    """

    def __init__(self, spec: FaultInjectSpec):
        self.spec = spec
        self._lock = threading.Lock()
        self.now = 0.0
        self.calls = 0
        self.errors = 0
        self.timeouts = 0
        self.crashed_calls = 0
        self.restarts = 0
        self.crashed = False
        #: the one-shot crash: armed until it fires, never re-armed
        self._crash_armed = spec.crash_at_s is not None

    def advance_to(self, t: float) -> None:
        """Move the injector's virtual clock (monotone; the cluster and
        the open-loop harness drive this)."""
        with self._lock:
            self.now = max(self.now, float(t))

    def restart(self) -> None:
        """The crashed process was replaced: serve again (the permanent
        crash does not re-fire; scheduled transient faults continue)."""
        with self._lock:
            self.crashed = False
            self.restarts += 1

    def check(self, now: Optional[float] = None, n: int = 1) -> None:
        """Count one call at virtual time ``now`` and raise its fault,
        if the schedule has one.  ``n`` is informational (batch size)."""
        spec = self.spec
        with self._lock:
            if now is not None:
                self.now = max(self.now, float(now))
            t = self.now
            c = self.calls
            self.calls += 1
            if self._crash_armed and spec.crash_at_s is not None and t >= spec.crash_at_s:
                self.crashed = True
                self._crash_armed = False
            if self.crashed:
                self.crashed_calls += 1
                raise InjectedCrash(
                    f"injected permanent crash (t={t:.6f}s >= "
                    f"crash_at_s={spec.crash_at_s})"
                )
            delay = spec.latency.delay_for(c) if spec.latency is not None else 0.0
            u_err = u_to = 1.0
            if spec.error_rate > 0 or spec.timeout_rate > 0:
                rng = np.random.default_rng((spec.seed, c))
                u_err, u_to = float(rng.random()), float(rng.random())
            fail_err = (
                spec.error_every > 0 and c % spec.error_every == 0
            ) or u_err < spec.error_rate
            fail_to = (
                spec.timeout_every > 0 and c % spec.timeout_every == 0
            ) or u_to < spec.timeout_rate
            if fail_err:
                self.errors += 1
            elif fail_to:
                self.timeouts += 1
        if delay > 0:
            time.sleep(delay)
        if fail_err:
            raise InjectedError(f"injected transient error (call {c})")
        if fail_to:
            raise InjectedTimeout(f"injected dispatch timeout (call {c})")


def inject_faults(spec: FaultInjectSpec) -> FaultInjector:
    """Compile a fault schedule to an injector (attach it to a shard via
    ``Cluster.inject_shard_faults``, or call ``check()`` around any
    callable)."""
    return FaultInjector(spec)


def corrupt_checkpoint(
    step_dir: str, mode: str = "tamper", seed: int = 0
) -> str:
    """Deterministically damage a checkpoint step directory's array file.

    ``mode="tamper"``   -- rewrite one seeded array element in
                           ``arrays.npz`` (the archive stays readable:
                           only the *manifest checksums* of
                           ``repro_torch.train.checkpoint`` can catch it);
    ``mode="truncate"`` -- cut the file short (a torn write: even the
                           archive layer fails).

    Returns the path of the damaged file.  Used by the fault benchmarks
    and tests to prove recovery falls back to the previous verified step
    instead of loading garbage.
    """
    path = os.path.join(step_dir, "arrays.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no arrays.npz under {step_dir}")
    if mode == "truncate":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
        return path
    if mode != "tamper":
        raise ValueError(f"mode must be tamper|truncate, got {mode!r}")
    rng = np.random.default_rng(seed)
    with np.load(path) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    # flip one element of a seeded non-empty array (deterministic order)
    names = sorted(k for k, v in arrays.items() if v.size > 0)
    if not names:
        raise ValueError(f"{path} holds no non-empty arrays to tamper with")
    name = names[int(rng.integers(len(names)))]
    arr = arrays[name]
    flat = arr.reshape(-1).view(np.uint8)
    flat[int(rng.integers(len(flat)))] ^= 0xFF
    tmp = path + ".tmp.npz"  # np.savez appends .npz to bare names
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


__all__ = [
    "FaultInjectSpec",
    "FaultInjector",
    "InjectedCrash",
    "InjectedError",
    "InjectedFault",
    "InjectedTimeout",
    "LatencyInjectSpec",
    "corrupt_checkpoint",
    "inject_faults",
    "inject_latency",
]
