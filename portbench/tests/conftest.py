"""A small checkout for the benchmark's CPU tests: this ``portbench`` copied
into a temporary root beside the program's ``src``, with tiny
configurations (the models' smoke widths, a 1024-entry cache, a stream of
200,000 requests) and mixes cut to batches of 256."""
import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
sys.path.insert(0, str(HERE))

MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 512, "rope_theta": 10000.0, "norm_eps": 1e-06,
         "qkv_bias": True, "dtype": "bfloat16"}
MOE = dict(MODEL, qkv_bias=False, n_experts=8, top_k=2, expert_d_ff=32, dense_residual_ff=32,
           capacity_factor=1.25)
CACHE = {"strategy": "STDv_LRU", "entries": 1024, "f_s": 0.5, "f_t": 0.4, "ways": 8,
         "value_dim": 8, "shards": 1, "routing": "hash"}


#: the smoke widths' limits: a one-ulp reordering reads 0.0078, the fp8
#: control 0.2-0.8
LIMITS = {"dense": {"backend_gap": 0.1}, "moe": {"backend_gap_p90": 0.1, "backend_rows_over_0.1": 0.05}}


def config(model, **cache):
    kind = "moe" if model.get("n_experts") else "dense"
    return {"source": "test", "reduced": [], "model": model, "cache": dict(CACHE, **cache),
            "stream": {"scale": 0.1, "train_frac": 0.7}, "limits": LIMITS[kind]}


@pytest.fixture
def root(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(HERE, pb, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (tmp_path / "src").symlink_to(REPO / "src")
    for name, cfg in (("tiny", config(MODEL)), ("tinymoe", config(MOE))):
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for mix in ("bulk", "poisson"):
        m = json.loads((pb / "traffic" / f"{mix}.json").read_text())
        m["batch"] = 256
        if "arrivals" in m:
            m["arrivals"]["rate"] = 2000.0
        (pb / "traffic" / f"{mix}.json").write_text(json.dumps(m))
    bench = {
        "workloads": [
            {"name": "tiny.bulk", "config": "tiny", "traffic": "bulk", "chips": 1},
            {"name": "tiny.poisson", "config": "tiny", "traffic": "poisson", "chips": 1},
            {"name": "tinymoe.bulk", "config": "tinymoe", "traffic": "bulk", "chips": 1}],
        "end_to_end": [
            {"name": "qps", "unit": "requests/s", "workloads": ["tiny.bulk", "tinymoe.bulk"]},
            {"name": "p95_ms", "unit": "ms", "workloads": ["tiny.poisson"]},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": [
            {"name": "hit_rate.bulk", "unit": "%", "moves": "qps",
             "workloads": ["tiny.bulk", "tinymoe.bulk"]},
            {"name": "broker_ms.bulk", "unit": "ms", "moves": "qps",
             "workloads": ["tiny.bulk", "tinymoe.bulk"]},
            {"name": "mfu.bulk", "unit": "%", "moves": "qps",
             "workloads": ["tiny.bulk", "tinymoe.bulk"]},
            {"name": "queue_ms.open", "unit": "ms", "moves": "p95_ms",
             "workloads": ["tiny.poisson"]},
            {"name": "mfu.open", "unit": "%", "moves": "p95_ms", "workloads": ["tiny.poisson"]}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def load_harness(root):
    """The harness of the copy under ``root`` (its configs, mixes and
    metrics), imported fresh."""
    for mod in ("harness", "readers", "arith", "refcache", "refmodel", "stream", "weights",
                "trace"):
        sys.modules.pop(mod, None)
    sys.path.insert(0, str(root / "portbench"))
    try:
        import harness
    finally:
        sys.path.pop(0)
    return harness


def run(root, cell, seed=11, seconds=1.0, trace=False, device="cpu", **kw):
    import time

    h = load_harness(root)
    return h.run_cell(root, cell, seed, seconds, trace, time.perf_counter(), device=device, **kw)
