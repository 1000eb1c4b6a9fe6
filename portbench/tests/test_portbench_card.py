"""The benchmark on the card at the smoke widths: a traced run of each
kind of cell, correct, with the device's fields and every per-layer
metric it can read."""
import json

import pytest
import torch

from conftest import run


def _longer_stream(root):
    """The card serves the smoke widths' batches in a few ms: a stream ten
    times longer (2M requests) outlasts the 1 s window."""
    for f in (root / "portbench" / "configs").glob("tiny*.json"):
        cfg = json.loads(f.read_text())
        cfg["stream"]["scale"] = 1.0
        f.write_text(json.dumps(cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.bulk", "tiny.poisson", "tinymoe.bulk"])
def test_traced_run_on_the_card(root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels and the device trace run only there")
    _longer_stream(root)
    out = run(root, cell, trace=True, device="cuda")
    assert out["correct"], out["checks"]
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"] * 1.01
    assert out["metrics"] and len(out["breakdown"]["device_ops"]) <= 10
