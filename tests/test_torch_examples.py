"""The port's examples (``examples/torch_*.py``) through their ``main`` on
the CPU at reduced sizes, against the JAX package where they print numbers.

``torch_cache_size_sweep``'s LRU hit counts must equal
``repro.core.lru_hits_all_sizes`` on the same ``SynthConfig``, integer for
integer; ``torch_quickstart``'s Bélády line must equal
``repro.core.belady_hit_rate`` on the same keys.  The serving and training
examples must exit 0 (their lines are the CLIs', held to the reference's in
``tests/test_torch_serve_cli.py`` and ``tests/test_torch_train.py``).
Without ``--device cpu`` an example runs on the card and raises where
there is none.
"""
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import core as jcore  # noqa: E402
from repro.querylog import SynthConfig, generate  # noqa: E402
from repro.topics import oracle_pipeline  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cache_size_sweep_equals_the_references_hits(capsys):
    assert _example("cache_size_sweep").main(
        ["--device", "cpu", "--requests", "20000", "--max-cap", "8192"]) == 0
    out = capsys.readouterr().out
    lines = re.findall(r"N=\s*([\d,]+): \d\.\d{4}  \((\d+) of (\d+) hits\)", out)
    assert [int(n.replace(",", "")) for n, _, _ in lines] == [1024, 2048, 4096, 8192]
    synth = generate(SynthConfig(n_requests=20_000, n_topics=32, n_topical_queries=80_000,
                                 n_notopic_queries=40_000, vocab_size=512, seed=1))
    pipe = oracle_pipeline(synth, train_frac=0.7)
    want = jcore.lru_hits_all_sizes(pipe.log, max_cap=8192)
    for n, hits, n_test in lines:
        assert int(hits) == int(want[int(n.replace(",", ""))])
        assert int(n_test) == len(pipe.log.test_keys)


def test_quickstart_belady_line_equals_the_references(capsys):
    assert _example("quickstart").main(
        ["--device", "cpu", "--requests", "20000", "--lda-iters", "2", "--lda-subsample", "2000",
         "--entries", "1024"]) == 0
    out = capsys.readouterr().out
    rates = re.findall(r"^  (.{13}) hit_rate=(\d\.\d{4})", out, re.M)
    assert len(rates) == len(jcore.STRATEGIES) + 1
    hits, n_test = map(int, re.search(r"Belady bound .*\((\d+) of (\d+) test", out).groups())
    synth = generate(SynthConfig(n_requests=20_000, n_topics=32, n_topical_queries=40_000,
                                 n_notopic_queries=20_000, vocab_size=1024, seed=0))
    n_train = synth.split(0.7)
    assert n_test == len(synth.keys) - n_train
    assert hits / n_test == jcore.belady_hit_rate(synth.keys, 1024, count_from=n_train)
    # the bound dominates every strategy
    assert all(float(r) <= hits / n_test + 5e-5 for _, r in rates)


def test_serve_example_exits_0(capsys):
    assert _example("serve_with_std_cache").main(
        ["--device", "cpu", "--requests", "5000", "--entries", "1024"]) == 0
    assert re.search(r"hit_rate=0\.\d+ static_hits=\d+", capsys.readouterr().out)


def test_train_example_exits_0(tmp_path, capsys):
    assert _example("train_lm").main(
        ["--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "step     3 loss" in out and out.rstrip().endswith("done")
    assert any(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["quickstart", "cache_size_sweep", "serve_with_std_cache",
                                  "train_lm"])
def test_examples_run_on_the_card_by_default(name, monkeypatch):
    """No fallback: without ``--device`` an example asks for the card, and
    with none the port raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(["--requests", "100"] if name != "train_lm" else ["--steps", "1"])
