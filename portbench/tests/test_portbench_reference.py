"""The plain references against the port's CPU path on the smoke widths,
and the check that decides ``correct`` against the timed path broken
underneath it: each fault a served cell can have makes ``correct`` false."""
import numpy as np
import pytest
import torch

from conftest import MODEL, MOE, REPO, run

import sys

sys.path.insert(0, str(REPO / "src"))

from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

import harness  # noqa: E402
import weights  # noqa: E402
from refmodel import Reference, top_ids, widest_gap  # noqa: E402
from stream import query_tokens  # noqa: E402


@pytest.mark.parametrize("model", [MODEL, MOE], ids=["dense", "moe"])
def test_reference_against_the_back_end(model):
    w = weights.make(model, 1234, torch.device("cpu"))
    params = tf.ParamTree(weights.tree(w))
    backend = cli.lm_backend(params, harness.transformer_config(tf, model), 8, device="cpu")
    qids = np.arange(0, 6400, 50)  # 128 rows, a power of two: no padding rows
    served = torch.from_numpy(backend(qids))
    logits = Reference(model, w).last_logits(torch.from_numpy(query_tokens(qids, 512)))
    assert widest_gap(logits, served) == 0.0
    assert torch.equal(top_ids(logits, 8), served.long())
    control = Reference(model, w, "fp8").last_logits(torch.from_numpy(query_tokens(qids, 512)))
    assert widest_gap(logits, top_ids(control, 8)) > 0.1


@pytest.mark.parametrize("cell", ["tiny.bulk", "tiny.poisson", "tinymoe.bulk"])
def test_sound_runs_are_correct(root, cell):
    out = run(root, cell)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["checks"].items()}
    assert got["unanswered"] == 0.0 and got["cache_mismatches"] == 0.0
    # bf16 products summed in another order may move a logit by an ulp
    assert got.get("backend_gap", got.get("backend_gap_p90")) < 0.05
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def _state_unchanged(monkeypatch):
    from repro_torch.serving.device_cache import STDDeviceCache
    real = STDDeviceCache.serve_one_call

    def frozen(self, state, *a, **k):
        keep = {n: state[n].clone() for n in ("ks", "value")}
        out = list(real(self, state, *a, **k))
        out[4] = dict(out[4], **keep)
        return tuple(out)

    monkeypatch.setattr(STDDeviceCache, "serve_one_call", frozen)


def _half_batch(monkeypatch):
    from repro_torch.serving import Cluster
    real = Cluster.serve

    def half(self, q):
        h = len(q) // 2
        v, hit = real(self, q[:h])
        return (np.concatenate([v, np.zeros((len(q) - h, v.shape[1]), v.dtype)]),
                np.concatenate([hit, np.zeros(len(q) - h, bool)]))

    monkeypatch.setattr(Cluster, "serve", half)


def _answer_altered(monkeypatch):
    real = cli.model_scores

    def altered(*a, **k):
        ids = real(*a, **k).clone()
        ids[:, -1] = (ids[:, -1] + 1) % 512
        return ids

    monkeypatch.setattr(cli, "model_scores", altered)


def _one_expert_wrong(monkeypatch):
    """Expert 0's FFN output negated in every layer, the rest sound."""
    real = tf._expert_ffn

    def wrong(cfg, x, wi, wo):
        y = real(cfg, x, wi, wo)
        return torch.cat([-y[:1], y[1:]]) if y.dim() == 3 else y

    monkeypatch.setattr(tf, "_expert_ffn", wrong)


@pytest.mark.parametrize("fault,cell", [
    (_state_unchanged, "tiny.bulk"), (_state_unchanged, "tiny.poisson"),
    (_state_unchanged, "tinymoe.bulk"),
    (_half_batch, "tiny.bulk"), (_half_batch, "tiny.poisson"), (_half_batch, "tinymoe.bulk"),
    (_answer_altered, "tiny.bulk"), (_answer_altered, "tiny.poisson"),
    (_answer_altered, "tinymoe.bulk"),
    (_one_expert_wrong, "tinymoe.bulk")],
    ids=lambda v: v if isinstance(v, str) else v.__name__.strip("_"))
def test_faults_are_not_correct(root, monkeypatch, fault, cell):
    fault(monkeypatch)
    out = run(root, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["tiny.bulk", "tinymoe.bulk"])
def test_the_control_is_not_correct(root, cell):
    """The reference in fp8, put in the back end's place, comes out not
    correct, on the same number that the program's sound runs keep to."""
    for seed in (1, 2, 3):
        sound = run(root, cell, seed=seed)
        out = run(root, cell, seed=seed, control=True)
        assert sound["correct"], sound["checks"]
        assert not out["correct"], out["checks"]
        over = [k for k, v in out["checks"].items() if v["value"] > v["limit"]]
        assert over and all(k.startswith("backend_") for k in over)
