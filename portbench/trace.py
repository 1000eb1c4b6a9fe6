"""Reading the device trace of a window: the kernels' spans, the device's
busy time (the union of the spans, so overlapping work counts once), the
busiest operations, and the longest idle gaps named by what the host was
doing in them.

The torch profiler records the device only (CUPTI); the host's spans are
the benchmark's own, on ``time.perf_counter``.  The two clocks are tied by
a marker: a small device op launched right after a synchronise, whose
kernel is the trace's first.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import torch


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


class DeviceTrace:
    """Profiles the device from ``start()`` to ``stop()``."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        self._profile = lambda: profile(activities=[ProfilerActivity.CUDA])
        # a first session starts the tracer, so the measured one records
        # from its first launch
        with self._profile():
            torch.zeros(1, device=device).add_(1)
            torch.cuda.synchronize(device)

    def start(self) -> None:
        torch.cuda.synchronize(self.device)
        self._prof = self._profile()
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.host0 = time.perf_counter()
        torch.zeros(1, device=self.device).fill_(3)  # the marker
        torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.host1 = time.perf_counter()
        time.sleep(0.05)  # lets the last activity buffer land
        self._prof.__exit__(None, None, None)
        ops = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = _ns(e, "start")
            d = _ns(e, "duration")
            if d > 0:
                ops.append((e.name(), s, s + d))
        if not ops:
            raise RuntimeError("the profiler recorded no device operation in the traced window")
        ops.sort(key=lambda o: o[1])
        marker = ops[0][1]
        #: (name, start_s, end_s) on the host's perf_counter clock
        self.ops: List[Tuple[str, float, float]] = [
            (n, self.host0 + (s - marker) / 1e9, self.host0 + (t - marker) / 1e9)
            for n, s, t in ops[1:]
        ]
        self.busy = _union(self.ops)

    @property
    def window_s(self) -> float:
        return self.host1 - self.host0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def top_ops(self, n: int = 10):
        tot = {}
        for name, a, b in self.ops:
            tot[name] = tot.get(name, 0.0) + (b - a)
        return sorted(([k[:120], v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, spans, n: int = 10):
        """The ``n`` longest idle stretches of the device, each named by the
        innermost host span (``spans``: (name, t0, t1)) around its middle."""
        edges = [self.host0] + [x for iv in self.busy for x in iv] + [self.host1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            inner = [s for s in spans if s[1] <= mid <= s[2]]
            name = min(inner, key=lambda s: s[2] - s[1])[0] if inner else "loop"
            out.append([name, b - a])
        return out


def _union(ops) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out
