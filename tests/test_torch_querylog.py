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


AOL = ("AnonID\tQuery\tQueryTime\tItemRank\tClickURL\n"
       "1\tWeather Boston!\t2006-03-01 07:17:12\t1\thttp://a\n"
       "1\tWeather Boston!\t2006-03-01 07:17:12\t2\thttp://b\n"
       "2\tbank of america\t2006-03-01 08:00:00\t\t\n"
       "3\t***\t2006-03-01 08:00:01\t\t\n"
       "3\tshort row\n"
       "4\tbad time\tyesterday\t\t\n"
       "1\tweather boston\t2006-03-02 07:00:00\t1\thttp://a\n")
MSN = ("Time\tQuery\tQueryID\tSessionID\tResultCount\n"
       "2006-05-01 00:00:08.790\tsome query\t1\ts1\t10\n"
       "2006-05-01 00:01:08.790\tSOME Query\t2\ts1\t10\n"
       "not a time\tother query\t3\ts2\t10\n"
       "2006-05-02 10:00:00\tOther, query!\t4\ts2\t10\n")


@pytest.mark.parametrize("fmt", ["aol", "msn"])
@pytest.mark.parametrize("has_header", [True, False])
def test_parsers_equal_reference(fmt, has_header):
    import io

    from repro.querylog import parse as ref_parse
    from repro_torch.querylog import parse as port_parse

    text = AOL if fmt == "aol" else MSN
    if not has_header:
        text = text.split("\n", 1)[1]
    fn = f"parse_{fmt}"
    want = getattr(ref_parse, fn)(io.StringIO(text), has_header=has_header)
    got = getattr(port_parse, fn)(io.StringIO(text), has_header=has_header)
    assert got.keys.dtype == want.keys.dtype and np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.timestamps, want.timestamps)
    assert got.query_text == want.query_text and got.click_url == want.click_url
    for a, b in zip(got.term_char_counts(), want.term_char_counts()):
        assert np.array_equal(a, b)
    assert port_parse.time_split(got.timestamps, 0.7) == ref_parse.time_split(want.timestamps, 0.7)


@pytest.mark.parametrize("q", ["  Hello,   WORLD!! ", "***", "", "Ünïcode café 42", "a\tb\nc"])
def test_normalize_query_equals_reference(q):
    from repro.querylog import normalize_query as ref_norm
    from repro_torch.querylog import normalize_query

    assert normalize_query(q) == ref_norm(q)
