"""The port's copy of the query-stream generator against the reference's
``repro.querylog.synth.generate``: for one config the request stream and
the ground-truth topics must be identical."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.querylog import synth as ref  # noqa: E402
from repro_torch.querylog import synth as port  # noqa: E402

CASES = {
    "defaults": dict(),
    "churn_no_decouple": dict(core_churn=0.25, decouple_diversity=False, n_topics=7,
                              singleton_fraction=0.6, n_days=3.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_equals_reference(case):
    kw = dict(n_requests=20_000, n_topical_queries=3_000, n_notopic_queries=1_200,
              n_buckets=64, vocab_size=64, seed=3, **CASES[case])
    want = ref.generate(ref.SynthConfig(**kw))
    keys, true_topic = port.generate_stream(port.SynthConfig(**kw))
    assert keys.dtype == want.keys.dtype and np.array_equal(keys, want.keys)
    assert np.array_equal(true_topic, want.true_topic)
    share = float(np.mean(true_topic[keys] != port.NO_TOPIC))
    assert abs(share - kw.get("topical_fraction", 0.62)) < 0.02
