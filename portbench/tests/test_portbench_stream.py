"""The frozen copies equal the program's originals on the same seeds: the
stream generator, the arrival stamping, the query hash and the token
windows."""
import numpy as np

from conftest import REPO

import sys

sys.path.insert(0, str(REPO / "src"))

from repro_torch.launch.serve import query_tokens as cli_tokens  # noqa: E402
from repro_torch.loadgen.arrivals import ArrivalSpec  # noqa: E402
from repro_torch.querylog.synth import SynthConfig, generate_stream  # noqa: E402
from repro_torch.serving.device_cache import splitmix64 as cache_hash  # noqa: E402

import stream  # noqa: E402


def test_stream_equals_the_generator():
    for seed in (0, 2**31 + 5):
        ours = stream.draw_stream(stream.StreamConfig.scaled(0.05, seed))
        theirs = generate_stream(SynthConfig(n_requests=100_000, n_topical_queries=15_000,
                                             n_notopic_queries=6_000, seed=seed))
        for a, b in zip(ours, theirs):
            assert np.array_equal(a, b)


def test_arrivals_equal_the_stamping():
    for proc in ("poisson", "onoff"):
        spec = ArrivalSpec(process=proc, rate=5000.0, seed=9)
        assert np.array_equal(stream.arrival_times(proc, 5000.0, 20_000, 9), spec.times(20_000))


def test_hash_and_tokens():
    q = np.concatenate([np.arange(100_000), [-1, 2**40]])
    assert np.array_equal(stream.splitmix64(q), cache_hash(q))
    assert np.array_equal(stream.query_tokens(q[:1000], 151_552), cli_tokens(q[:1000], 151_552))


def test_a_configuration_may_fix_its_stream():
    import harness

    fixed = {"scale": 0.01, "train_frac": 0.7, "seed": 11}
    free = {"scale": 0.01, "train_frac": 0.7}
    assert harness.stream_config(fixed, 1) == harness.stream_config(fixed, 2)
    assert harness.stream_config(free, 1).seed == 1 and harness.stream_config(free, 2).seed == 2
    a = stream.draw_stream(harness.stream_config(fixed, 1))
    b = stream.draw_stream(harness.stream_config(fixed, 99))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
