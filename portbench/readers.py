"""The arithmetic of the metrics, shared by the readers in ``metrics/``.

Each reader takes the run (``harness.run_cell``'s record of the window:
its serve calls, back-end calls, spans, counters, the device trace and
the cache replay) and returns a number, or None when the run has nothing
for it to read.  Shares are in percent.
"""
from __future__ import annotations

import numpy as np

import arith


def setup_s(run):
    return run.setup_s


def qps(run):
    if run.mix["loop"] != "closed":
        return None
    return sum(x.n for x in run.window) / (run.t_end - run.t0)


def _latency(run):
    """Per request due in the window: from its due time to the return of
    the serve call that answered it; an unanswered request waits out the
    drain limit."""
    from harness import DRAIN_LIMIT_S

    lat = np.full(run.n_due, run.seconds + DRAIN_LIMIT_S)
    start = np.full(run.n_due, np.nan)
    for x in run.window:
        lo, hi = x.lo - run.w_lo, x.hi - run.w_lo
        lat[lo:hi] = x.t1 - (run.t0 + run.due[lo:hi])
        start[lo:hi] = x.t0 - (run.t0 + run.due[lo:hi])
    return lat, start


def p95_ms(run):
    if run.due is None:
        return None
    return float(np.percentile(_latency(run)[0], 95)) * 1e3


def queue_ms(run):
    if run.due is None:
        return None
    start = _latency(run)[1]
    return float(np.nanmean(start)) * 1e3


def broker_ms(run):
    """Mean host milliseconds of a serve call outside its back-end calls."""
    inside = {}
    for b in run.backend_calls:
        inside[b.serve] = inside.get(b.serve, 0.0) + (b.t1 - b.t0)
    if not run.window:
        return None
    return float(np.mean([x.t1 - x.t0 - inside.get(x.idx, 0.0) for x in run.window])) * 1e3


def hit_rate(run):
    d = {k: getattr(run.after, k) - getattr(run.before, k)
         for k in ("requests", "static_hits", "topic_hits")}
    if not d["requests"]:
        return None
    return 100.0 * (d["static_hits"] + d["topic_hits"]) / d["requests"]


def _model_flops(run):
    return sum(len(b.qids) for b in run.backend_calls) * run.row_flops


def mfu_window(run):
    """The misses' model FLOPs over the window's seconds at the bf16 peak."""
    if not run.backend_calls:
        return None
    return 100.0 * _model_flops(run) / ((run.t_end - run.t0) * arith.BF16_FLOP_PER_S)


def mfu_backend(run):
    """The misses' model FLOPs over the seconds inside back-end calls."""
    busy = sum(b.t1 - b.t0 for b in run.backend_calls)
    if busy <= 0:
        return None
    return 100.0 * _model_flops(run) / (busy * arith.BF16_FLOP_PER_S)


def idle_share(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


#: the serve kernel's two launches, the deferred fill and the
#: probe/commit/gather, by their symbols as the trace names them (plain or
#: mangled); PyTorch's own ``fill_kernel_cuda`` is not one of them
def is_serve_kernel(name: str) -> bool:
    n = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
    return "probe_and_commit_kernel" in n or n.startswith("fill_kernel(") or "11fill_kernelP" in n


def serve_fused_roofline(run):
    """The serve kernel's byte bound at the HBM rate over its device time,
    summed over the window's calls (its two kernels: the deferred fill and
    the probe/commit/gather)."""
    if run.trace is None or not run.window:
        return None
    t = sum(b - a for name, a, b in run.trace.ops if is_serve_kernel(name))
    if t <= 0:
        return None
    rp, ways = run.replay, run.cfg["cache"]["ways"]
    vdim = run.cfg["cache"]["value_dim"]
    total = 0
    # a call applies the deferred fill of the call before it
    for prev, x in zip([run.window_prev] + run.window[:-1], run.window):
        sl = slice(x.lo, x.hi)
        n_sets = arith.distinct(rp.sets[sl][~rp.static[sl]])
        rows = rp.hit_row[sl]
        n_fill = int(rp.inserted[prev.lo:prev.hi].sum())
        total += arith.serve_call_bytes(arith.pow2(max(x.n, run.min_bucket)), n_sets, ways,
                                        vdim, n_fill, arith.distinct(rows[rows >= 0]))
    return 100.0 * total / arith.HBM_BYTES_PER_S / t
