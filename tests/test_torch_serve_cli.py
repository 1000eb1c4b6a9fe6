"""The port's serving CLI (``python -m repro_torch.launch.serve --device
cpu``) against the reference CLI (``python -m repro.launch.serve``) on the
same flags, both in process.

The LM back end's weights differ (a torch generator against
``PRNGKey(0)``), so the served values differ; which requests hit does not
depend on them.  Each case holds the lines that are a function of the
flags and the seeds to equality: closed loop, the ``hit_rate=...
static_hits=... topic_hits=... backend_calls=...`` line, the
``rebalances=`` line and the per-shard lines; open loop, the served / shed
/ deferred counts and hit rate, the SLO verdict (its p99 target set past
any measured latency), the ``resilience:`` line and the outage spans, all
on the virtual clock.  The exit codes must agree and be 0.
"""
import re

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.launch import serve as ref_cli  # noqa: E402
from repro_torch.launch import serve as port_cli  # noqa: E402

BASE = ["--requests", "20000", "--entries", "1024"]

CASES = {
    "topic_routed_pipelined": ["--shards", "4", "--routing", "topic", "--pipeline", "4"],
    "drift_rebalance": ["--drift-phases", "4", "--rebalance", "8", "--shards", "2"],
    "open_loop_crash": ["--open-loop", "--shards", "2", "--fault-shard", "1@0.02",
                        "--slo-p99-ms", "1e9", "--min-availability", "1.0"],
}

_KEEP = (
    re.compile(r"^(hit_rate=\S+ static_hits=\d+ topic_hits=\d+ backend_calls=\d+ hedged=\d+)$"),
    re.compile(r"^(rebalances=\d+ migrated_entries=\d+)"),
    re.compile(r"^(  shard \d+: requests=\d+ hit_rate=\S+)$"),
    re.compile(r"^(served \d+/\d+ \(shed \d+, deferred \d+\)) throughput=(\d+) req/s"),
    re.compile(r" (hit_rate=\S+) pad_overhead=\S+$"),
    re.compile(r"^(SLO: .*)$"),
    re.compile(r"^(resilience: .*)$"),
    re.compile(r"^(  shard \d+ outage: .*)$"),
)


def _deterministic_lines(out: str):
    kept = []
    for line in out.splitlines():
        for pat in _KEEP:
            m = pat.search(line)
            if m:
                kept.extend(m.groups())
    return kept


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_cli_prints_the_reference_lines(case, capsys):
    argv = BASE + CASES[case]
    rc_ref = ref_cli.main(argv)
    out_ref = capsys.readouterr().out
    rc_port = port_cli.main(argv + ["--device", "cpu"])
    out_port = capsys.readouterr().out
    want, got = _deterministic_lines(out_ref), _deterministic_lines(out_port)
    assert got == want
    assert rc_port == rc_ref == 0
    if case == "open_loop_crash":
        assert "recoveries=1" in out_port and "availability=1.0000" in out_port
    else:
        assert any(line.startswith("hit_rate=") for line in got)
    assert "(host engine: none)" not in out_port  # the port serves on its device engine
