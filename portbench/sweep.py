"""Find a mix's knee: the highest rate the card sustains without a growing
backlog.  One process sets the cell up once (``harness.setup``), then runs
an open loop of Poisson arrivals at each rate in turn, over the stream's
next requests, and prints its queue, its backlog at the close and its
latency, one JSON line a rate.

    python3 portbench/sweep.py --workload glm4-9b.poisson --seed 5 \\
        --rates 5000,6000,7000 --seconds 8

The rate found goes into the mix's file by hand; the benchmark's runs do
not search.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))


def backlog(calls, due: np.ndarray, lo0: int, ts: float, secs: float) -> dict:
    """How an open loop kept up: its queue at the calls' starts early and
    late in the window, its backlog at the close, its latency."""
    queue = np.array([np.searchsorted(due, x.t0 - ts, side="right") - (x.lo - lo0)
                      for x in calls])
    third = max(len(calls) // 3, 1)
    closed = sum(x.n for x in calls if x.t1 <= ts + secs)
    lat = np.concatenate([x.t1 - (ts + due[x.lo - lo0:x.hi - lo0]) for x in calls])
    return {"calls": len(calls), "mean_batch": float(np.mean([x.n for x in calls])),
            "queue_first_third": float(queue[:third].mean()),
            "queue_last_third": float(queue[-third:].mean()),
            "backlog_at_close": int(len(due) - closed),
            "drained_s": calls[-1].t1 - ts - secs,
            "p50_ms": float(np.median(lat)) * 1e3, "p95_ms": float(np.percentile(lat, 95)) * 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(prog="portbench/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args()
    import harness
    from stream import arrival_times

    st = harness.setup(Path.cwd(), args.workload, args.seed, T_START)
    secs = args.seconds
    try:
        for rate in [float(r) for r in args.rates.split(",")]:
            due = arrival_times("poisson", rate, int(rate * secs * 1.5) + 1024, st.seed + 2)
            due = due[due < secs]
            lo0, k0 = st.pos, len(st.calls)
            if lo0 + len(due) > len(st.test):
                raise harness.Fail("the stream ran out in the sweep: raise its scale")
            ts = time.perf_counter()
            harness.open_loop(lambda i, j: st.serve(lo0 + i, lo0 + j, "sweep"), due, secs,
                              st.batch, ts, [])
            st.pos = st.calls[-1].hi
            print(json.dumps({"rate": rate, "seconds": secs,
                              **backlog(st.calls[k0:], due, lo0, ts, secs)}), flush=True)
    except harness.Fail as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    finally:
        st.cluster.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
