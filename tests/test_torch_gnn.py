"""The port's GNN family (PNA) on the CPU against the JAX package's.

The same numpy-seeded inputs go through ``repro.models.gnn`` and
``repro_torch.models.gnn``, the reference's weights carried across by
``params_from_numpy``.  Graphs carry the traps of the reference's segment
ops: isolated nodes, ReLU'd messages whose maxima and minima tie at 0,
duplicate edges (tied positive maxima), and pad edges ``(0, n)`` and
``(0, -1)`` (training batches) or ``(n, n)`` (molecules).

Tolerances (f32 on both; the two sum in other orders):

* ``_pna_aggregate`` on the same messages: rtol 1e-5, atol 1e-6, its
  gradient too (ties split evenly on both);
* logits on graphs where no node's messages are all one message: rtol
  1e-5, atol 1e-5; losses rtol 1e-5; gradients rtol 1e-4 and atol 1e-6 of
  the tree's largest entry, as the recsys losses';
* on power-law graphs (``make_random_graph``'s hubs), where a node often
  gets k >= 2 copies of one message, its std is ``sqrt(max(sq - mean^2,
  1e-8))`` of a variance that is 0 up to rounding: the floor 1e-4 or the
  square root of one rounding of ``m^2`` (~5e-4 |m|), as the last bit of
  ``m`` falls, and the two packages' matrix products round ``m`` apart (the
  variance's own arithmetic is the same: given equal messages the two
  compute it bit for bit).  The std's gradient ``(m_i - mean) / (k std)``
  is rounding noise over a tiny std, so both f32 gradients miss the
  float64 one by up to ~1% of the largest entry.  There the algorithm is
  held in float64 (the port against the reference under
  ``jax.enable_x64``: logits rtol 1e-10, gradients rtol 1e-6 and atol 1e-7
  of the largest entry, the loss's f32 log-softmax being the one f32 step
  in both), and in f32 the port's gradient, like the reference's, must be
  within 1% of the largest entry of the float64 gradient (checked for the
  reference too); logits within 1e-3 of the largest logit;
* after one AdamW step: parameters within 1e-5 (the first step moves each
  entry by about lr times the sign of its gradient, so an entry whose
  gradient is rounding noise may move the other way), the first moment as
  the gradients.

The numpy functions the port copies (``make_random_graph``,
``NeighborSampler``, ``partition_edges_by_dst``) must give the reference's
draws exactly.
"""
import dataclasses as dc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_smoke_mesh  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402

AGG_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6
PARAM_ATOL = 1e-5
#: power-law graphs (module docstring): logits relative to the largest
#: logit; float64 logits and gradients
HUB_LOGIT_ATOL_REL = 1e-3
F64_LOGIT_RTOL = 1e-10
F64_GRAD_RTOL, F64_GRAD_ATOL_REL = 1e-6, 1e-7
HUB_GRAD_ATOL_REL = 1e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_config(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)}
    kw["dtype"] = torch.float32
    return tgnn.PNAConfig(**kw)


def _models(jcfg, seed=0):
    jp = jgnn.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, tgnn.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _assert_grads_close(tg, jg, atol_rel=GRAD_ATOL_REL):
    fj, ft = _flat(jg), _flat(tg)
    assert fj.keys() == ft.keys()
    atol = atol_rel * max(np.abs(_np(w)).max() for w in fj.values())
    for key, want in fj.items():
        got = ft[key]
        assert got.dtype == torch.float32 and tuple(got.shape) == np.shape(want), key
        np.testing.assert_allclose(_np(got), _np(want), rtol=GRAD_RTOL, atol=atol, err_msg=key)


def _to_f64(tree):
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float64)
                        if np.asarray(a).dtype == np.float32 else np.asarray(a), tree)


def _jax_f64_value_and_grad(jcfg, jp, batch):
    """The reference's loss and gradients in float64 (``jax.enable_x64``)."""
    with jax.enable_x64(True):
        loss, grads = jax.value_and_grad(jgnn.loss_fn)(
            jax.tree.map(jnp.asarray, _to_f64(jp)),
            {k: jnp.asarray(v) for k, v in _to_f64(batch).items()},
            dc.replace(jcfg, dtype=jnp.float64))
        return float(loss), jax.tree.map(np.asarray, grads)


def _assert_as_close_as_the_reference(tg, jg32, jg64, scale=1.0):
    """The port's and the reference's f32 gradients (times ``scale``) both
    within 1% of the largest entry of the float64 gradient."""
    fj, ft, f64 = _flat(jg32), _flat(tg), _flat(jg64)
    assert fj.keys() == ft.keys() == f64.keys()
    atol = HUB_GRAD_ATOL_REL * scale * max(np.abs(w).max() for w in f64.values())
    for key, exact in f64.items():
        for who, g in (("reference", fj[key]), ("port", ft[key])):
            err = np.abs(_np(g) - scale * exact).max()
            assert err <= atol, (key, who, err, atol)


def _graph(seed, n, e, d_feat, n_classes, pads=("0n", "0m1"), power_law=False, n_isolated=3):
    """A random graph with isolated nodes (0 .. n_isolated - 1 get no
    message), duplicate edges (tied positive maxima) and pad edges of the
    given kinds appended: ``"0n"`` = (0, n), ``"0m1"`` = (0, -1), ``"nn"``
    = (n, n).  Uniform sources: every duplicated edge's destination also
    gets an edge from another source, so no node's messages are all one
    message (module docstring)."""
    g = jgnn.make_random_graph(n, e, d_feat, n_classes, seed=seed, power_law=power_law)
    ei = g["edge_index"]
    ei[1][np.isin(ei[1], np.arange(n_isolated))] = n_isolated
    others = [j for j in range(ei.shape[1]) if len(set(ei[0][ei[1] == ei[1, j]])) > 1]
    ei = np.concatenate([ei, ei[:, others[:10]]], axis=1)  # duplicates
    pad = {"0n": (0, n), "0m1": (0, -1), "nn": (n, n)}
    extra = np.array([pad[k] for k in pads for _ in range(3)], np.int64).T.reshape(2, -1)
    return g["x"], np.concatenate([ei, extra], axis=1), g["labels"]


def _one_message_nodes(ei, n):
    """Nodes whose 2 or more in-edges all come from one source."""
    real = (ei[1] >= 0) & (ei[1] < n)
    src, dst = ei[0][real], ei[1][real]
    return [v for v in range(n) if (dst == v).sum() >= 2 and len(set(src[dst == v])) == 1]


# -- the aggregation ----------------------------------------------------------------


def test_pna_aggregate_on_the_known_graph():
    """tests/test_models.py's graph (1->0, 2->0; nodes 1 and 2 isolated)
    and the same messages with ReLU ties: values and the gradient of a
    weighted sum of the 12 views, against the reference."""
    rng = np.random.default_rng(0)
    cfg = jgnn.PNAConfig(n_layers=1, d_in=4, d_hidden=2, n_classes=2, delta=1.0)
    params = jgnn.init_params(jax.random.PRNGKey(0), cfg)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    h = x @ np.asarray(params["encode"])
    cases = [np.maximum(h[[1, 2]], 0), np.array([[0.0, 1.5], [0.0, 1.5]], np.float32),
             np.array([[0.0, 0.0], [0.0, 0.7]], np.float32)]
    dst = np.array([0, 0])
    for msgs in cases:
        w = rng.normal(size=(3, 24)).astype(np.float32)

        def jf(m):
            return (jgnn._pna_aggregate(m, jnp.asarray(dst), 3, cfg.delta) * w).sum()

        want, want_g = jax.value_and_grad(jf)(jnp.asarray(msgs))
        tm = torch.from_numpy(msgs).requires_grad_(True)
        agg = tgnn._pna_aggregate(tm, torch.from_numpy(dst), 3, cfg.delta)
        np.testing.assert_allclose(
            agg.detach().numpy(),
            np.asarray(jgnn._pna_aggregate(jnp.asarray(msgs), jnp.asarray(dst), 3, cfg.delta)),
            **AGG_TOL)
        (agg * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(tm.grad.numpy(), np.asarray(want_g), **AGG_TOL)
        assert np.abs(agg.detach().numpy()[1:]).max() < 1e-3  # isolated: ~0 (std's floor)


def test_pna_aggregate_drops_sink_destinations():
    """Destinations n and -1 reach no node and no degree."""
    rng = np.random.default_rng(1)
    msgs = np.maximum(rng.normal(size=(12, 5)).astype(np.float32), 0)
    dst = np.array([0, 0, 1, 4, 4, -1, 2, 2, 2, 4, -1, 0])
    want = jgnn._pna_aggregate(jnp.asarray(msgs), jnp.asarray(dst), 4, 2.5)
    got = tgnn._pna_aggregate(torch.from_numpy(msgs), torch.from_numpy(dst), 4, 2.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **AGG_TOL)
    keep = (dst >= 0) & (dst < 4)
    alone = tgnn._pna_aggregate(torch.from_numpy(msgs[keep]), torch.from_numpy(dst[keep]), 4, 2.5)
    assert torch.equal(got, alone)


# -- forward, batched molecules, the loss -------------------------------------------


@pytest.mark.parametrize("pads", [("0n", "0m1"), ("nn",), ()])
def test_forward_equals_the_reference(pads):
    jcfg = jgnn.PNAConfig(n_layers=3, d_in=12, d_hidden=10, n_classes=5)
    jp, tp = _models(jcfg)
    x, ei, _ = _graph(2, 40, 160, 12, 5, pads=pads)
    assert not _one_message_nodes(ei, 40)
    mask = (np.arange(40) % 3 > 0).astype(np.float32)
    for m in (None, mask):
        want = jgnn.forward(jp, jnp.asarray(x), jnp.asarray(ei), jcfg,
                            node_mask=None if m is None else jnp.asarray(m))
        got = tgnn.forward(tp, torch.from_numpy(x), torch.from_numpy(ei), _port_config(jcfg),
                           node_mask=None if m is None else torch.from_numpy(m))
        assert got.shape == (40, 5) and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_forward_on_a_power_law_graph_equals_the_reference():
    """``make_random_graph``'s hubs: nodes that get one message k times
    (module docstring for the tolerance)."""
    jcfg = jgnn.PNAConfig(n_layers=3, d_in=12, d_hidden=10, n_classes=5)
    jp, tp = _models(jcfg)
    x, ei, _ = _graph(2, 40, 160, 12, 5, power_law=True)
    assert _one_message_nodes(ei, 40)
    want = np.asarray(jgnn.forward(jp, jnp.asarray(x), jnp.asarray(ei), jcfg))
    got = tgnn.forward(tp, torch.from_numpy(x), torch.from_numpy(ei), _port_config(jcfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL["rtol"],
                               atol=HUB_LOGIT_ATOL_REL * np.abs(want).max())


def test_a_repeated_message_has_the_same_variance_in_both():
    """k copies of one message: given the same messages, the two packages'
    aggregates are equal bit for bit, the variance's rounding included."""
    m = np.full((7, 3), 2.3116028, np.float32)
    m[:, 1] = 0.0
    dst = np.full(7, 1)
    want = jgnn._pna_aggregate(jnp.asarray(m), jnp.asarray(dst), 3, 2.5)
    got = tgnn._pna_aggregate(torch.from_numpy(m), torch.from_numpy(dst), 3, 2.5)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_forward_batched_equals_the_references_vmap():
    """Padded molecules ((n, n) pad edges, masked pad nodes, one molecule
    with no edge) flattened into one graph against the reference's vmap."""
    jcfg = jgnn.PNAConfig(n_layers=2, d_in=9, d_hidden=8, n_classes=4)
    jp, tp = _models(jcfg, seed=3)
    rng = np.random.default_rng(3)
    b, n, e = 6, 12, 20
    n_real = rng.integers(4, n + 1, size=b)
    x = rng.normal(size=(b, n, 9)).astype(np.float32)
    ei = np.full((b, 2, e), n, np.int64)
    for i in range(b):
        k = 0 if i == 2 else int(rng.integers(1, e + 1))
        ei[i, :, :k] = rng.integers(0, n_real[i], size=(2, k))
    ei[0, :, :3] = [[1, 1, 1], [2, 2, 2]]  # duplicate edges
    mask = (np.arange(n)[None] < n_real[:, None]).astype(np.float32)
    x *= mask[..., None]
    want = jgnn.forward_batched(jp, jnp.asarray(x), jnp.asarray(ei), jnp.asarray(mask), jcfg)
    got = tgnn.forward_batched(tp, torch.from_numpy(x), torch.from_numpy(ei),
                               torch.from_numpy(mask), _port_config(jcfg))
    assert got.shape == (b, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("power_law", [False, True])
@pytest.mark.parametrize("with_mask", [True, False])
def test_loss_and_gradients_equal_jax_value_and_grad(with_mask, power_law):
    """``loss_fn`` and its gradients on a graph with tied maxima and minima
    (ReLU zeros, duplicate edges), isolated nodes and (0, n)/(0, -1) pads;
    on a power-law graph against the float64 gradient (module docstring)."""
    jcfg = jgnn.PNAConfig(n_layers=2, d_in=10, d_hidden=12, n_classes=6)
    jp, tp = _models(jcfg, seed=1)
    x, ei, labels = _graph(5, 50, 220, 10, 6, power_law=power_law)
    assert bool(_one_message_nodes(ei, 50)) == power_law
    batch = {"x": x, "edge_index": ei, "labels": labels}
    if with_mask:
        batch["label_mask"] = (np.random.default_rng(5).random(50) < 0.6).astype(np.float32)
    jl, jg = jax.value_and_grad(jgnn.loss_fn)(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                                              jcfg)
    tl, tg = tsteps.value_and_grad(tgnn.loss_fn)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, _port_config(jcfg))
    assert tl.dtype == torch.float32 and np.isfinite(float(jl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    if not power_law:
        _assert_grads_close(tg, jg)
        return
    l64, g64 = _jax_f64_value_and_grad(jcfg, jp, batch)
    _assert_as_close_as_the_reference(tg, jg, g64)
    # the algorithm itself, in float64
    cfg64 = dc.replace(_port_config(jcfg), dtype=torch.float64)
    tl64, tg64 = tsteps.value_and_grad(tgnn.loss_fn)(
        tgnn.params_from_numpy(_to_f64(jax.tree.map(np.asarray, jp)), device="cpu"),
        {k: torch.from_numpy(v) for k, v in _to_f64(batch).items()}, cfg64)
    np.testing.assert_allclose(float(tl64), l64, rtol=LOSS_RTOL)
    f64, ft64 = _flat(g64), _flat(tg64)
    top = max(np.abs(w).max() for w in f64.values())
    for key, want in f64.items():
        assert ft64[key].dtype == torch.float64, key
        np.testing.assert_allclose(ft64[key].numpy(), want, rtol=F64_GRAD_RTOL,
                                   atol=F64_GRAD_ATOL_REL * top, err_msg=key)


def test_forward_in_float64_on_a_power_law_graph_equals_the_reference():
    jcfg = jgnn.PNAConfig(n_layers=3, d_in=12, d_hidden=10, n_classes=5)
    jp, _ = _models(jcfg)
    x, ei, _ = _graph(2, 40, 160, 12, 5, pads=("0n", "0m1", "nn"), power_law=True)
    with jax.enable_x64(True):
        want = np.asarray(jgnn.forward(jax.tree.map(jnp.asarray, _to_f64(jp)),
                                       jnp.asarray(x.astype(np.float64)), jnp.asarray(ei),
                                       dc.replace(jcfg, dtype=jnp.float64)))
    got = tgnn.forward(tgnn.params_from_numpy(_to_f64(jax.tree.map(np.asarray, jp)), "cpu"),
                       torch.from_numpy(x.astype(np.float64)), torch.from_numpy(ei),
                       dc.replace(_port_config(jcfg), dtype=torch.float64))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=F64_LOGIT_RTOL,
                               atol=F64_LOGIT_RTOL * np.abs(want).max())


def test_the_references_nan_gradient_through_a_molecule_pad():
    """ROADMAP.md Queue 3's limit of the reference: with a pad edge (n, n)
    its logits are finite but its gradient is NaN (``jnp.take`` reads a NaN
    row).  The port's is finite and equals the gradient without the pad."""
    jcfg = jgnn.PNAConfig(n_layers=1, d_in=3, d_hidden=4, n_classes=2)
    jp, tp = _models(jcfg)
    x = np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)
    ei = np.array([[0, 3], [1, 3]])
    jg = jax.grad(lambda p: jgnn.forward(p, jnp.asarray(x), jnp.asarray(ei), jcfg).sum())(jp)
    assert np.isnan(np.asarray(jg["layers"][0]["msg"])).all()
    tcfg = _port_config(jcfg)

    def grads(edges):
        _, g = tsteps.value_and_grad(lambda p: tgnn.forward(
            p, torch.from_numpy(x), torch.from_numpy(edges), tcfg).sum())(tp)
        return tcommon.tree_leaves(g)

    padded, bare = grads(ei), grads(ei[:, :1])
    assert all(bool(torch.isfinite(a).all()) and torch.equal(a, b) for a, b in zip(padded, bare))


def test_forward_dist_waits_for_the_mesh():
    """``forward_dist`` is ported: without batch axes on the mesh (or
    without a mesh) it is ``forward``; on a one-rank mesh its one shard
    holds every node, and the values are ``forward``'s (on 4 ranks against
    the reference: tests/test_torch_dist.py)."""
    from repro_torch.launch.mesh import make_smoke_mesh

    cfg = tgnn.PNAConfig(n_layers=2, d_in=3, d_hidden=4, n_classes=2)
    params = tgnn.init_params(torch.Generator().manual_seed(0), cfg)
    g = tgnn.make_random_graph(12, 40, 3, 2, seed=1)
    x, ei = torch.from_numpy(g["x"]), torch.from_numpy(g["edge_index"])
    want = tgnn.forward(params, x, ei, cfg)
    assert torch.equal(tgnn.forward_dist(params, x, ei, cfg, None, ("data",)), want)
    mesh = make_smoke_mesh(device="cpu")
    try:
        assert torch.equal(tgnn.forward_dist(params, x, ei, cfg, mesh, ("pod",)), want)
        part = torch.from_numpy(tgnn.partition_edges_by_dst(g["edge_index"], 12, 1))
        torch.testing.assert_close(tgnn.forward_dist(params, x, part, cfg, mesh, ("data",)), want,
                                   rtol=1e-6, atol=1e-6)
    finally:
        torch.distributed.destroy_process_group()


# -- the numpy copies ----------------------------------------------------------------


@pytest.mark.parametrize("power_law", [True, False])
@pytest.mark.parametrize("d_feat", [0, 7])
def test_make_random_graph_draws_equal_the_references(power_law, d_feat):
    want = jgnn.make_random_graph(300, 2000, d_feat, 5, seed=3, power_law=power_law)
    got = tgnn.make_random_graph(300, 2000, d_feat, 5, seed=3, power_law=power_law)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k


@pytest.mark.parametrize("fanouts", [(15, 10), (3, 2, 2)])
def test_neighbor_sampler_blocks_equal_the_references(fanouts):
    g = jgnn.make_random_graph(500, 4000, 0, 3, seed=4)
    seeds = np.random.default_rng(0).choice(500, size=24, replace=False)
    js, ts = jgnn.NeighborSampler(500, g["edge_index"], seed=2), tgnn.NeighborSampler(
        500, g["edge_index"], seed=2)
    assert np.array_equal(js.nbr, ts.nbr) and np.array_equal(js.offsets, ts.offsets)
    for _ in range(2):  # the sampler's generator carries across calls
        for w, t in zip(js.sample_block(seeds, fanouts), ts.sample_block(seeds, fanouts)):
            assert w.dtype == t.dtype and np.array_equal(w, t)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_partition_edges_by_dst_equals_the_references(n_shards):
    g = jgnn.make_random_graph(64, 300, 0, 3, seed=4)
    want = jgnn.partition_edges_by_dst(g["edge_index"], 64, n_shards)
    got = tgnn.partition_edges_by_dst(g["edge_index"], 64, n_shards)
    assert want.dtype == got.dtype and np.array_equal(want, got)


def test_forward_on_a_partitioned_edge_list_equals_the_references():
    """The partition's (0, -1) sink edges through ``forward``."""
    jcfg = jgnn.PNAConfig(n_layers=2, d_in=8, d_hidden=6, n_classes=3)
    jp, tp = _models(jcfg, seed=4)
    g = jgnn.make_random_graph(64, 300, 8, 3, seed=4)
    ei = tgnn.partition_edges_by_dst(g["edge_index"], 64, 5)
    assert (ei[1] == -1).any()
    want = jgnn.forward(jp, jnp.asarray(g["x"]), jnp.asarray(g["edge_index"]), jcfg)
    got = tgnn.forward(tp, torch.from_numpy(g["x"]), torch.from_numpy(ei), _port_config(jcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


# -- the registry and the steps ------------------------------------------------------


def test_pna_config_and_params_equal_the_references():
    ja, ta = jreg.get_arch("pna"), treg.get_arch("pna")
    assert (ta.name, ta.family, ta.notes) == (ja.name, ja.family, ja.notes)
    assert [dc.asdict(s) for s in ta.shapes] == [dc.asdict(s) for s in ja.shapes]
    for jc, tc in ((ja.config, ta.config), (ja.smoke_config, ta.smoke_config)):
        assert _port_config(jc) == tc and tc.d_agg == jc.d_agg
    want = jax.tree.map(np.asarray, jgnn.init_params(jax.random.PRNGKey(0), ja.config))
    got = tgnn.init_params(torch.Generator().manual_seed(0), ta.config)
    fw, fg = _flat(want), _flat(got)
    assert fw.keys() == fg.keys()
    for key, a in fw.items():
        assert tuple(fg[key].shape) == a.shape and fg[key].dtype == torch.float32, key
        scale = a.shape[0] ** -0.5
        assert float(fg[key].abs().max()) <= 2 * scale + 1e-6, key
        assert abs(float(fg[key].std()) / scale - 0.8796) < 0.05, key


def _reference_bundle(name):
    arch = jreg.get_arch("pna")
    with make_smoke_mesh() as mesh:
        return jsteps.build_gnn_step(arch, arch.shape(name), mesh, smoke=True)


@pytest.mark.parametrize("name", ["full_graph_sm", "minibatch_lg", "ogb_products"])
def test_train_step_equals_the_references_step(name):
    """``build_gnn_step`` at the smoke config: the batch has the
    reference's padded shapes and the reference's ``model_flops``; one
    AdamW step's loss, parameters and first moment against the reference
    bundle's step run eagerly on the same weights and batch (a power-law
    graph: the first moment, 0.1 x the clipped gradient, as close to the
    float64 one as the reference's)."""
    jarch, tarch = jreg.get_arch("pna"), treg.get_arch("pna")
    jp, tp = _models(jarch.smoke_config, seed=2)
    step = tsteps.build_gnn_step(tarch, tarch.shape(name), tp, torch.Generator().manual_seed(3),
                                 device="cpu", smoke=True)
    bundle = _reference_bundle(name)
    assert {k: tuple(s.shape) for k, s in bundle.inputs[2].items()} == \
        {k: tuple(v.shape) for k, v in step.batch.items()}
    assert step.model_flops == bundle.model_flops
    b = step.batch
    n = b["x"].shape[0]
    assert bool((b["edge_index"][1] == n).any()), "the smoke batch has pad edges"
    assert 0 < float(b["label_mask"].sum()) < n
    if name == "minibatch_lg":
        assert float(b["label_mask"].sum()) == tsteps._SMOKE_SEEDS
    with make_smoke_mesh():
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
        jp2, js2, jout = bundle.fn(jp, joptim.init_opt_state(jp), jbatch)
    tp2, ts2, tout = step.fn(step.batch)
    assert tp2 is tp and ts2 is step.opt_state and int(ts2.step) == int(js2.step) == 1
    np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), rtol=LOSS_RTOL)
    fw, fg = _flat(jp2), _flat(tcommon.tree_map(lambda t: t, tp2))
    assert fw.keys() == fg.keys()
    for key, w in fw.items():
        np.testing.assert_allclose(_np(fg[key]), _np(w), rtol=GRAD_RTOL, atol=PARAM_ATOL,
                                   err_msg=key)
    batch_np = {k: v.numpy() for k, v in b.items()}
    _, g64 = _jax_f64_value_and_grad(jarch.smoke_config, jp, batch_np)
    norm = np.sqrt(sum(float((w**2).sum()) for w in _flat(g64).values()))
    _assert_as_close_as_the_reference(ts2.mu, js2.mu, g64, scale=0.1 * min(1.0, 1.0 / norm))
    _, ts3, out3 = step.fn(step.batch)
    assert int(ts3.step) == 2 and float(out3["loss"]) < float(tout["loss"])


def test_molecule_serve_step_equals_the_references():
    jarch, tarch = jreg.get_arch("pna"), treg.get_arch("pna")
    jp, tp = _models(jarch.smoke_config, seed=5)
    step = tsteps.build_gnn_step(tarch, tarch.shape("molecule"), tp,
                                 torch.Generator().manual_seed(4), device="cpu", smoke=True)
    bundle = _reference_bundle("molecule")
    assert {k: tuple(s.shape) for k, s in bundle.inputs[1].items()} == \
        {k: tuple(v.shape) for k, v in step.batch.items()}
    assert step.model_flops == bundle.model_flops
    b = step.batch
    n = b["x"].shape[1]
    real = b["node_mask"].bool()
    assert 0 < int(real.sum()) < real.numel() and bool((b["x"][~real] == 0).all())
    assert bool((b["edge_index"] == n).any()) and int(b["edge_index"].max()) == n
    with make_smoke_mesh():
        want = bundle.fn(jp, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
    got = step.fn(step.batch)
    assert got.shape == (8, tarch.smoke_config.n_classes)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL["rtol"],
                               atol=HUB_LOGIT_ATOL_REL * np.abs(want).max())


def test_batches_are_seeded():
    arch = treg.get_arch("pna")
    for name in ("molecule", "minibatch_lg"):
        a, b = (tsteps.gnn_batch(arch, arch.shape(name), torch.Generator().manual_seed(9),
                                 smoke=True) for _ in range(2))
        assert all(torch.equal(a[k], b[k]) for k in a)
