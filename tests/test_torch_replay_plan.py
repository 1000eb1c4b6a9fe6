"""The LM back end's replay plan (``repro_torch.launch.serve._replay_plans``)
as a pure function of the graphs' measured replay times: which captured
CUDA graphs a call of n ids replays.

A dense model's call is covered by the cheapest set of graphs whose rows
add up to at least n, largest first, its padding only in the last one; an
MoE model's call replays the one graph of the next power of two, whatever
the times.  Held to a brute force over every set of graphs."""
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch.serve import _graph_rows, _replay_plans  # noqa: E402

DENSE = get_arch("gemma-2b").smoke_config
MOE = get_arch("arctic-480b").smoke_config
SIZES = [1 << i for i in range(13)]  # the graphs of a graph_max of 4096
#: a compute-bound model: a fixed cost (the weights' read) plus rows x compute
AFFINE = {g: 6.0 + 0.3 * g for g in SIZES}
#: a model whose replays cost the same up to 64 rows (weight reads), then compute
FLAT64 = {g: 20.0 * max(g, 64) / 64 for g in SIZES}
#: noisy measured times, not monotone in the rows
NOISY = {g: float(t) for g, t in zip(SIZES[:7], np.random.default_rng(3).uniform(1.0, 9.0, 7))}


def _brute_force(costs, n):
    """The least total cost of a set of graphs covering n rows."""
    return min(sum(costs[g] for g in s) for k in range(1, len(costs) + 1)
               for s in itertools.combinations(costs, k) if sum(s) >= n)


@pytest.mark.parametrize("cfg, costs, n_max, n, want", [
    (DENSE, AFFINE, 4096, 1030, (1024, 8)),
    (DENSE, AFFINE, 4096, 1024, (1024,)),
    (DENSE, AFFINE, 4096, 4096, (4096,)),
    (DENSE, AFFINE, 3000, 3000, (2048, 512, 256, 128, 64)),
    (DENSE, FLAT64, 4096, 45, (64,)),
    (DENSE, NOISY, 64, 64, None),
    (MOE, {}, 4096, 1030, (2048,)),
    (MOE, AFFINE, 4096, 45, (64,)),
], ids=["dense-1030", "dense-1024", "dense-graph_max", "dense-graph_max-3000", "flat-45",
        "noisy-brute-force", "moe-1030", "moe-45"])
def test_replay_plan(cfg, costs, n_max, n, want):
    plans = _replay_plans(cfg, costs, n_max)
    assert len(plans) == n_max + 1 and plans[0] == ()
    if want is not None:
        assert plans[n] == want
    for m in range(1, n_max + 1):
        plan = plans[m]
        if cfg.moe is not None:
            assert plan == (_graph_rows(m),)  # never split
            continue
        assert sum(plan) >= m and sum(plan) - plan[-1] < m  # the padding in the last graph
        assert list(plan) == sorted(set(plan), reverse=True)  # each graph once, largest first
        cost = sum(costs[g] for g in plan)
        assert cost <= costs[_graph_rows(m)] + 1e-9
        if len(costs) <= 7:
            assert cost == pytest.approx(_brute_force(costs, m))
