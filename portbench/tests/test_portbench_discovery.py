"""A configuration, a traffic mix and a metric added as new files, and
entries in ``BENCHMARK.json``, with no other edit: the harness finds them
by name."""
import json

from conftest import MODEL, config, load_harness, run


def test_new_config_mix_and_metric(root):
    pb = root / "portbench"
    (pb / "configs" / "wider.json").write_text(json.dumps(config(dict(MODEL, d_model=96,
                                                                       head_dim=24),
                                                                 entries=2048)))
    mix = json.loads((pb / "traffic" / "bulk.json").read_text())
    mix["batch"] = 128
    (pb / "traffic" / "bulk128.json").write_text(json.dumps(mix))
    (pb / "metrics" / "calls.bulk.py").write_text(
        '"""Serve calls in the window."""\n\n\ndef read(run):\n    return len(run.window)\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "wider.bulk128", "config": "wider",
                               "traffic": "bulk128", "chips": 1})
    bench["end_to_end"][0]["workloads"].append("wider.bulk128")
    bench["per_layer"].append({"name": "calls.bulk", "unit": "calls", "moves": "qps",
                               "workloads": ["wider.bulk128"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = run(root, "wider.bulk128", trace=False)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"qps", "setup_s"}
    h = load_harness(root)
    _, cell, cfg, mix = h.find_cell(root, "wider.bulk128")
    assert cfg["model"]["d_model"] == 96 and cfg["cache"]["entries"] == 2048
    assert mix["batch"] == 128
    names = [m["name"] for m in h.metrics_for(bench, cell, True)]
    assert names == ["calls.bulk"]
    assert h.reader("calls.bulk")(type("R", (), {"window": [1, 2, 3]})) == 3


def test_metrics_follow_their_cells(root):
    h = load_harness(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    e2e = lambda c: [m["name"] for m in h.metrics_for(bench, cells[c], False)]  # noqa: E731
    per = lambda c: [m["name"] for m in h.metrics_for(bench, cells[c], True)]  # noqa: E731
    assert e2e("tiny.bulk") == ["qps", "setup_s"]
    assert e2e("tiny.poisson") == ["p95_ms", "setup_s"]
    assert per("tiny.poisson") == ["queue_ms.open", "mfu.open"]
    assert per("tinymoe.bulk") == ["hit_rate.bulk", "broker_ms.bulk", "mfu.bulk"]
    # a metric without a workloads key goes to every cell reporting what it moves
    bench["per_layer"].append({"name": "p", "unit": "ms", "moves": "p95_ms"})
    assert per("tiny.poisson")[-1] == "p" and "p" not in per("tiny.bulk")


def test_traced_metrics_without_a_trace_are_left_out(root):
    out = run(root, "tiny.bulk")
    h = load_harness(root)
    import readers
    assert readers.idle_share(type("R", (), {"trace": None})) is None
    assert out["metrics"]["qps"]["value"] > 0 and h
