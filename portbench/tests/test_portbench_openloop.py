"""The open loop's accounting against a fake server that stalls once: the
stall shows in the tail and in the queueing, every request is answered
once, in order."""
import time
from types import SimpleNamespace

import numpy as np

import readers
from harness import closed_loop, open_loop
from stream import arrival_times


def _drive(stall_at=None, stall_s=0.3, seconds=1.0, rate=3000.0, batch=64):
    due = arrival_times("poisson", rate, int(rate * seconds * 1.5), seed=5)
    due = due[due < seconds]
    calls, spans = [], []

    def serve(i, j):
        t0 = time.perf_counter()
        time.sleep(stall_s if stall_at is not None and i <= stall_at < j else 0.002)
        calls.append(SimpleNamespace(idx=len(calls), lo=i, hi=j, n=j - i, t0=t0,
                                     t1=time.perf_counter()))

    t0 = time.perf_counter()
    done = open_loop(serve, due, seconds, batch, t0, spans)
    run = SimpleNamespace(due=due, n_due=len(due), window=calls, w_lo=0, t0=t0,
                          seconds=seconds, backend_calls=[])
    return done, run


def test_every_request_answered_once_in_order():
    done, run = _drive()
    assert done == run.n_due
    assert run.window[0].lo == 0 and run.window[-1].hi == run.n_due
    assert all(a.hi == b.lo for a, b in zip(run.window, run.window[1:]))
    assert max(x.n for x in run.window) <= 64


def test_a_stall_shows_in_the_tail_and_the_queue():
    _, calm = _drive()
    _, stalled = _drive(stall_at=len(calm.due) // 3)
    assert readers.p95_ms(calm) < 50
    # the requests that arrive during a 300 ms stall wait for it: at 3000/s
    # that is ~900 of ~3000, so the 95th percentile lies inside the stall
    assert readers.p95_ms(stalled) > 100
    assert readers.queue_ms(stalled) > 5 * readers.queue_ms(calm)
    lat, start = readers._latency(stalled)
    assert np.all(lat >= start) and np.all(start >= 0)


def test_unanswered_requests_count_as_missing():
    done, run = _drive()
    run.window = run.window[:-3]
    assert readers.p95_ms(run) >= 0
    lat, _ = readers._latency(run)
    assert (lat == run.seconds + 60.0).sum() == sum(1 for _ in range(run.n_due)) - sum(
        x.n for x in run.window)


def test_closed_loop_stops_after_the_window():
    served = []
    t0 = time.perf_counter()
    n = closed_loop(lambda i, j: (served.append((i, j)), time.sleep(0.01)), 10_000, 0.1, 100, t0)
    assert n == len(served) * 100 and 5 <= len(served) <= 20
    assert closed_loop(lambda i, j: None, 250, 10.0, 100, time.perf_counter()) == 200
