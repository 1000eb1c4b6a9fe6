"""``tools/span_breakdown.py`` on the CPU, on a ``portbench`` checkout cut to
test sizes (the models' smoke widths, a 1024-entry cache, a stream of
200,000 requests, batches of 256): an untraced window reports no span
metric; a traced one reports the four, ``broker_host_ms`` +
``broker_wait_ms`` agrees with the benchmark's ``broker_ms``, and the back
end's counters agree with the benchmark's record of its calls."""
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import span_breakdown  # noqa: E402

MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 512, "rope_theta": 10000.0, "norm_eps": 1e-06,
         "qkv_bias": True, "dtype": "bfloat16"}
CONFIG = {"source": "test", "reduced": [], "model": MODEL,
          "cache": {"strategy": "STDv_LRU", "entries": 1024, "f_s": 0.5, "f_t": 0.4, "ways": 8,
                    "value_dim": 8, "shards": 1, "routing": "hash"},
          "stream": {"scale": 0.1, "train_frac": 0.7}, "limits": {"backend_gap": 0.1}}
METRICS = ("broker_host_ms", "broker_wait_ms", "backend_host_ms", "backend_pad_share",
           "backend_split_share")
#: the benchmark's top-level modules, imported from the copy and dropped after
BENCH_MODULES = ("harness", "readers", "arith", "refcache", "refmodel", "stream", "weights",
                 "trace")


@pytest.fixture
def root(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", pb,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (tmp_path / "src").symlink_to(REPO / "src")
    (pb / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    for mix in ("bulk", "poisson"):
        m = json.loads((pb / "traffic" / f"{mix}.json").read_text())
        m["batch"] = 256
        if "arrivals" in m:
            m["arrivals"]["rate"] = 2000.0
        (pb / "traffic" / f"{mix}.json").write_text(json.dumps(m))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({"workloads": [
        {"name": "tiny.bulk", "config": "tiny", "traffic": "bulk", "chips": 1},
        {"name": "tiny.poisson", "config": "tiny", "traffic": "poisson", "chips": 1}]}))
    for mod in BENCH_MODULES:
        sys.modules.pop(mod, None)
    sys.path.insert(0, str(pb))
    try:
        yield tmp_path
    finally:
        sys.path.remove(str(pb))
        for mod in BENCH_MODULES:
            sys.modules.pop(mod, None)


@pytest.mark.parametrize("cell", ["tiny.bulk", "tiny.poisson"])
def test_windows_off_and_on(root, cell):
    import harness

    st = harness.setup(root, cell, 11, time.perf_counter(), "cpu")
    try:
        first = len(st.calls)
        off = span_breakdown.run_window(st, 0, "off", 0.5)
        mid = len(st.calls)
        on = span_breakdown.run_window(st, 1, "on", 0.5)
    finally:
        st.cluster.close()
    e2e = "qps" if cell == "tiny.bulk" else "p95_ms"
    for w, lo, hi in ((off, first, mid), (on, mid, len(st.calls))):
        assert w[e2e] > 0 and w["serve_calls"] == hi - lo > 0
        rows = [len(b.qids) for b in st.rec.calls if lo <= b.serve < hi]
        c = w["counters"]
        assert (c["calls"], c["rows"], c["graph_rows"], c["eager_calls"]) == (
            len(rows), sum(rows), sum(rows), len(rows))  # the CPU runs eagerly
    assert not set(METRICS) & set(off)
    assert set(METRICS) <= set(on)
    assert on["backend_pad_share"] == on["backend_split_share"] == 0.0
    assert abs(on["broker_host_ms"] + on["broker_wait_ms"] - on["broker_ms"]) <= 0.3
    assert on["broker_wait_ms"] > 0 and on["backend_host_ms"] > 0
    assert on["span_ms"]["cluster.serve"] >= on["span_ms"]["broker.serve"]


def test_span_metrics_arithmetic():
    ms = 1_000_000
    spans = [("cluster.serve", 0, 10 * ms, -1, 0, 4), ("broker.serve", 1 * ms, 9 * ms, 0, 0, 4),
             ("broker.fetch", 2 * ms, 3 * ms, 1, 0, 4), ("broker.miss", 4 * ms, 8 * ms, 1, 0, 3),
             ("backend.call", 4 * ms, 8 * ms, 3, 0, 3), ("backend.fetch", 6 * ms, 7 * ms, 4, 0, 3),
             ("cluster.serve", 20 * ms, 22 * ms, -1, 1, 2),
             ("broker.fetch", 20 * ms, 21 * ms, 6, 1, 2)]
    c0 = {"calls": 2, "rows": 10, "graph_rows": 12, "split_calls": 1}
    c1 = {"calls": 6, "rows": 55, "graph_rows": 76, "split_calls": 2}
    got = span_breakdown.span_metrics(spans, c0, c1)
    assert got["broker_host_ms"] == pytest.approx(np.mean([10 - 1 - 4, 2 - 1]))
    assert got["broker_wait_ms"] == pytest.approx(1.0)
    assert got["backend_host_ms"] == pytest.approx(3.0)
    assert got["backend_pad_share"] == pytest.approx(100 * 19 / 64)
    assert got["backend_split_share"] == pytest.approx(100 * 1 / 4)
    assert got["span_ms"]["broker.fetch"] == pytest.approx(1.0)


def test_split_share_only_where_the_back_end_counts_split_calls():
    """A program whose back end counts no ``split_calls`` (an older tree's)
    gets its pad share and no split share."""
    c0 = {"calls": 3, "rows": 10, "graph_rows": 16}
    c1 = {"calls": 5, "rows": 40, "graph_rows": 64}
    got = span_breakdown.span_metrics([], c0, c1)
    assert got == {"backend_pad_share": pytest.approx(100 * 18 / 48)}
    got = span_breakdown.span_metrics([], {**c0, "split_calls": 0}, {**c1, "split_calls": 2})
    assert got["backend_split_share"] == pytest.approx(100.0)


def test_idle_by_span_names_each_gap_by_its_innermost_span():
    from types import SimpleNamespace

    # busy [1, 2] and [4, 5] in a window [0, 10]: gaps [0, 1], [2, 4], [5, 10]
    dt = SimpleNamespace(host0=0.0, host1=10.0, busy=[(1.0, 2.0), (4.0, 5.0)])
    spans = [("serve", 0.0, 9.0), ("broker.serve", 2.5, 3.5), ("queue", 2.9, 8.0),
             ("backend.call", 2.8, 3.2)]
    got = span_breakdown.idle_by_span(dt, spans)
    # mids 0.5 (serve), 3.0 (backend.call: the shortest of four), 7.5 (queue)
    assert got == {"queue": 5.0, "backend.call": 2.0, "serve": 1.0}
