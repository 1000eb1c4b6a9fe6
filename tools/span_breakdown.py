"""Where a benchmark cell's serve calls spend their time, by the program's
own spans: windows of a ``portbench`` cell with ``repro_torch.serving.
tracing`` on or off, and the device trace tied to the same clock.

    PYTHONPATH=src python tools/span_breakdown.py --workload glm4-9b.poisson \\
        --seed 7 --seconds 10 --plan off,on,on,off,trace [--out FILE]

One process sets the cell up as ``portbench/harness.py`` does (its
``setup``: stream, weights, graphs, static fill, warm cache), then runs a
window per entry of ``--plan``, each on the stream's next requests:
``off`` (tracing off), ``on`` (tracing on) or ``trace`` (tracing on and the
device profiled).  Each window prints one JSON line: its end-to-end metric
(``qps`` in a closed loop, ``p95_ms`` in an open one) and ``broker_ms``
as the benchmark reads them, the back end's counters, and with tracing on

- ``broker_host_ms``: mean over serve calls of ``cluster.serve`` time in
  neither ``broker.fetch`` nor ``backend.call``;
- ``broker_wait_ms``: mean over serve calls of time in ``broker.fetch``;
- ``backend_host_ms``: mean over back-end calls of ``backend.call`` time
  outside ``backend.fetch``;
- ``backend_pad_share``: 100 x (graph rows - rows) / graph rows, from the
  back end's counters over the window;
- ``backend_split_share``: 100 x split calls / calls, the share of the
  window's back-end calls covered by more than one graph (from the same
  counters, where the back end counts ``split_calls``);
- ``span_ms``: mean ms per serve call in each span name.

A ``trace`` window adds the device's idle share, its longest idle gaps
and its idle seconds by span, each gap named by the innermost span (the
program's, the benchmark's ``serve``/``backend``/``queue``, or ``gc``: a
collection of the interpreter's cyclic garbage collector) around its
middle, and the disagreement of the two clock ties.  The device trace
finds its opening and closing markers (an int16 fill) by name, and maps
device times onto ``time.perf_counter`` between them.  Needs the card
for ``trace``; ``--device cpu`` runs the rest at test sizes.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

#: the int16 fill that marks a traced window's two ends
MARKER = "FillFunctor<short>"


def tied_trace_class():
    """``portbench/trace.py``'s ``DeviceTrace`` with a marker at each end
    of the window, found by its kernel's name and left out of ``ops``;
    where the two ties disagree by more than 0.1 ms, device times are
    mapped linearly between them (durations kept)."""
    import trace as trace_mod

    class TiedTrace(trace_mod.DeviceTrace):
        def _mark(self) -> None:
            torch.empty(1, dtype=torch.int16, device=self.device).fill_(3)

        def start(self) -> None:
            torch.cuda.synchronize(self.device)
            self._prof = self._profile()
            self._prof.__enter__()
            torch.cuda.synchronize(self.device)
            self.host0 = time.perf_counter()
            self._mark()
            torch.cuda.synchronize(self.device)

        def stop(self) -> None:
            torch.cuda.synchronize(self.device)
            self.host1 = time.perf_counter()
            self._mark()
            torch.cuda.synchronize(self.device)
            time.sleep(0.05)  # lets the last activity buffer land
            self._prof.__exit__(None, None, None)
            ops = []
            for e in self._prof.profiler.kineto_results.events():
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    continue
                s, d = trace_mod._ns(e, "start"), trace_mod._ns(e, "duration")
                if d > 0:
                    ops.append((e.name(), s, s + d))
            ops.sort(key=lambda o: o[1])
            marks = [i for i, o in enumerate(ops) if MARKER in o[0]]
            if len(marks) < 2:
                raise RuntimeError(f"the trace holds {len(marks)} of its two markers")
            m0, m1 = ops[marks[0]][1], ops[marks[-1]][1]
            host = self.host1 - self.host0
            #: device time between the markers less host time between the ties
            self.tie_disagreement_s = (m1 - m0) / 1e9 - host
            scale = host / ((m1 - m0) / 1e9) if abs(self.tie_disagreement_s) > 1e-4 else 1.0
            drop = {marks[0], marks[-1]}
            self.ops = []
            for i, (n, s, t) in enumerate(ops):
                if i not in drop:
                    a = self.host0 + (s - m0) / 1e9 * scale
                    self.ops.append((n, a, a + (t - s) / 1e9))
            self.busy = trace_mod._union(self.ops)

    return TiedTrace


def _union_within(ivs, lo, hi) -> float:
    """Seconds of ``[lo, hi]`` covered by the intervals ``ivs``."""
    tot, end = 0.0, lo
    for a, b in sorted(ivs):
        a, b = max(a, end), min(b, hi)
        if b > a:
            tot += b - a
            end = b
    return tot


def span_metrics(spans, counters0, counters1) -> dict:
    """The four metrics and the per-call time by span name, from the
    window's spans (``tracing.take()``) and the back end's counters at
    its start and end."""
    out = {}
    rows = counters1["rows"] - counters0["rows"]
    graph = counters1["graph_rows"] - counters0["graph_rows"]
    if graph:
        out["backend_pad_share"] = 100.0 * (graph - rows) / graph
    calls = counters1.get("calls", 0) - counters0.get("calls", 0)
    if calls and "split_calls" in counters1:
        out["backend_split_share"] = 100.0 * (counters1["split_calls"]
                                              - counters0["split_calls"]) / calls
    by_call = {}
    for s in spans:
        by_call.setdefault(s[4], []).append(s)
    roots = [s for s in spans if s[0] == "cluster.serve"]
    if roots:
        host, wait = [], []
        for r in roots:
            lo, hi = r[1] / 1e9, r[2] / 1e9
            mine = by_call[r[4]]
            fetch = [(s[1] / 1e9, s[2] / 1e9) for s in mine if s[0] == "broker.fetch"]
            back = [(s[1] / 1e9, s[2] / 1e9) for s in mine if s[0] == "backend.call"]
            wait.append(_union_within(fetch, lo, hi))
            host.append(hi - lo - _union_within(fetch + back, lo, hi))
        out["broker_host_ms"] = float(np.mean(host)) * 1e3
        out["broker_wait_ms"] = float(np.mean(wait)) * 1e3
        tot = {}
        for s in spans:
            tot[s[0]] = tot.get(s[0], 0.0) + (s[2] - s[1]) / 1e6
        out["span_ms"] = {k: v / len(roots) for k, v in sorted(tot.items())}
    calls = [i for i, s in enumerate(spans) if s[0] == "backend.call"]
    if calls:
        fetch = {}
        for s in spans:
            if s[0] == "backend.fetch" and s[3] >= 0:
                fetch[s[3]] = fetch.get(s[3], 0) + (s[2] - s[1])
        out["backend_host_ms"] = float(np.mean(
            [(spans[i][2] - spans[i][1] - fetch.get(i, 0)) / 1e6 for i in calls]))
    return out


def idle_by_span(dtrace, spans):
    """Idle seconds of the device summed by the innermost (shortest) span
    around each gap's middle: one sweep over the gaps in time order."""
    import heapq

    edges = [dtrace.host0] + [x for iv in dtrace.busy for x in iv] + [dtrace.host1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    todo = sorted(spans, key=lambda s: s[1])
    live, j, out = [], 0, {}
    for a, b in gaps:
        mid = (a + b) / 2
        while j < len(todo) and todo[j][1] <= mid:
            name, t0, t1 = todo[j][:3]
            heapq.heappush(live, (t1 - t0, t1, name))
            j += 1
        while live and live[0][1] < mid:
            heapq.heappop(live)
        name = live[0][2] if live else "loop"
        out[name] = out.get(name, 0.0) + (b - a)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def run_window(st, k: int, mode: str, seconds: float, tied=None) -> dict:
    """Window ``k`` of the plan, on the stream from ``st.pos``."""
    import harness
    import readers
    from stream import arrival_times

    from repro_torch.serving import tracing

    calls, rec, test, batch = st.calls, st.rec, st.test, st.batch
    first, w_lo, h_first = len(calls), st.pos, len(st.spans)
    c0 = dict(rec.backend.counters)
    dtrace = tied(st.dev) if mode == "trace" else None
    if st.dev.type == "cuda":
        torch.cuda.synchronize(st.dev)
    tracing.take()
    if mode != "off":
        tracing.enable()
    pauses, gc_start = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            pauses.append(("gc", gc_start[0], time.perf_counter()))

    if dtrace is not None:
        gc.callbacks.append(on_gc)
        dtrace.start()
    t0 = time.perf_counter()
    serve = lambda i, j: st.serve(w_lo + i, w_lo + j, "window")  # noqa: E731
    due = None
    if st.mix["loop"] == "closed":
        n = (len(test) - w_lo) // batch * batch
        done = harness.closed_loop(serve, n, seconds, batch, t0)
        if done >= n:
            raise harness.Fail("the stream ran out in the window")
        t_end, n_due = calls[-1].t1, done
    else:
        a = st.mix["arrivals"]
        n_max = min(len(test) - w_lo, int(a["rate"] * seconds * 1.5) + 1024)
        due = arrival_times(a["process"], a["rate"], n_max, st.seed + 1 + k,
                            **{x: v for x, v in a.items() if x not in ("process", "rate")})
        n_due = int(np.searchsorted(due, seconds))
        if n_due >= n_max:
            raise harness.Fail("the stream ran out in the window")
        due = due[:n_due]
        harness.open_loop(serve, due, seconds, batch, t0, st.spans)
        t_end = t0 + seconds
    if dtrace is not None:
        dtrace.stop()
        gc.callbacks.remove(on_gc)
    tracing.disable()
    spans = tracing.take()
    c1 = dict(rec.backend.counters)
    window = calls[first:]
    st.pos = window[-1].hi
    run = SimpleNamespace(mix=st.mix, window=window, t0=t0, t_end=t_end, due=due, n_due=n_due,
                          seconds=seconds, w_lo=w_lo,
                          backend_calls=[b for b in rec.calls if b.serve >= first])
    out = {"window": k, "mode": mode, "serve_calls": len(window),
           "requests": sum(x.n for x in window), "n_due": n_due,
           "broker_ms": readers.broker_ms(run),
           "counters": {x: c1[x] - c0[x] for x in c1}}
    if due is None:
        out["qps"] = readers.qps(run)
    else:
        out["p95_ms"] = readers.p95_ms(run)
        out["queue_ms"] = readers.queue_ms(run)
    if mode != "off":
        out.update(span_metrics(spans, c0, c1))
        out["spans"] = len(spans)
    if dtrace is not None:
        named = (st.spans[h_first:] + [(s[0], s[1] / 1e9, s[2] / 1e9) for s in spans]
                 + pauses)
        out["idle_share"] = 100.0 * (1.0 - dtrace.busy_s / dtrace.window_s)
        out["tie_disagreement_ms"] = dtrace.tie_disagreement_s * 1e3
        out["idle_gaps"] = dtrace.idle_gaps(named, 12)
        out["idle_s_by_span"] = idle_by_span(dtrace, named)
        out["device_ops"] = dtrace.top_ops(6)
        out["gc_pauses"] = len(pauses)
        out["gc_ms"] = sum(b - a for _, a, b in pauses) * 1e3
    return out


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/span_breakdown.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--plan", default="off,on,on,off,trace")
    ap.add_argument("--root", default=str(ROOT), help="a checkout with BENCHMARK.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also append each line to this file")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    root = Path(args.root)
    sys.path.insert(0, str(root / "portbench"))
    import harness

    plan = args.plan.split(",")
    if set(plan) - {"off", "on", "trace"}:
        raise SystemExit(f"--plan takes off, on and trace, got {args.plan!r}")
    if "trace" in plan and args.device != "cuda":
        raise SystemExit("a trace window needs the card")
    st = harness.setup(root, args.workload, args.seed, t_start, args.device)
    tied = tied_trace_class() if "trace" in plan else None
    head = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds,
            "card": card() if args.device == "cuda" else "cpu",
            "setup_s": time.perf_counter() - t_start}
    lines = [head]
    print(json.dumps(head), flush=True)
    for k, mode in enumerate(plan):
        line = run_window(st, k, mode, args.seconds, tied)
        lines.append(line)
        print(json.dumps(line), flush=True)
    st.cluster.close()
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
