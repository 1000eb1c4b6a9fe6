"""The port's sharding rules against the reference's, leaf for leaf.

For each of the 10 architectures at its full published config: the port's
meta parameter tree against the reference's ``jax.eval_shape`` of its init
(paths, shapes, dtypes), then the port's ``spec_for_path`` of every leaf
against the reference's on three meshes of names and sizes only --
(1, 1), (16, 16) and (2, 16, 16), the port's ``AbstractMesh`` beside
``jax.sharding.AbstractMesh`` -- and the same for every optimizer-state
leaf (AdamW's moments, Adafactor's factored statistics), and ``batch_spec``
and ``kv_cache_spec`` at every cell's dims.  A spec is compared entry by
entry with the reference's ``PartitionSpec``.  Also the cases of
``tests/test_dryrun_unit.py``'s ``divisible_suffix``, ``_sanitize`` and
``batch_spec`` on the port's one-rank mesh of names, and the DTensor
placements a spec becomes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import shardings as tsh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.common import meta_init, tree_map_with_path  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

MESHES = [((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
DTYPES = {np.dtype("float32"): torch.float32, np.dtype("int32"): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _jmesh(shape, axes):
    try:
        return JAbstractMesh(shape, axes)
    except TypeError:  # older jax: one tuple of (name, size) pairs
        return JAbstractMesh(tuple(zip(axes, shape)))


def _ref_leaves(tree):
    return [("/".join(jsteps._k(k) for k in path), tuple(leaf.shape), DTYPES[np.dtype(leaf.dtype)])
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree):
    out = []
    tree_map_with_path(lambda p, t: out.append((p, tuple(t.shape), t.dtype)), tree)
    return out


def _abstract(arch):
    """(reference's eval_shape'd tree, the port's meta tree) of the full config."""
    jarch, tarch = jreg.ARCHS[arch], treg.ARCHS[arch]
    key = jax.random.PRNGKey(0)
    if jarch.family == "lm":
        return (jax.eval_shape(lambda: jtf.init_params(key, jarch.config)),
                ttf.abstract_params(tarch.config).tree())
    if jarch.family == "gnn":
        return (jax.eval_shape(lambda: jgnn.init_params(key, jarch.config)),
                meta_init(tgnn.init_params, tarch.config))
    return (jax.eval_shape(lambda: jsteps._RECSYS_INIT[arch](key, jarch.config)),
            meta_init(tsteps.RECSYS_INIT[arch], tarch.config))


def _opt(arch, jp, tp):
    jarch = jreg.ARCHS[arch]
    if jarch.family == "lm" and jsteps._lm_optimizer(jarch) == "adafactor":
        return (jax.eval_shape(lambda: joptim.init_adafactor_state(jp)),
                toptim.init_adafactor_state(tp))
    return jax.eval_shape(lambda: joptim.init_opt_state(jp)), toptim.init_opt_state(tp)


def _dims_of(arch):
    """(batch, rank) pairs and (batch, seq, n_kv) triples of every cell."""
    jarch = jreg.ARCHS[arch]
    batches, caches = set(), set()
    for s in jarch.shapes:
        d = s.dims
        for key in ("global_batch", "batch", "n_candidates", "n_nodes", "block_nodes"):
            if key in d:
                batches.update((d[key], r) for r in (1, 2, 3))
        if jarch.family == "lm":
            caches.add((d["global_batch"], d["seq_len"], jarch.config.n_kv_heads))
    return sorted(batches), sorted(caches)


@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_specs_of_every_leaf_equal_the_references(arch):
    jp, tp = _abstract(arch)
    ref, port = _ref_leaves(jp), _port_leaves(tp)
    assert [p for p, _, _ in port] == [p for p, _, _ in ref]
    assert port == ref
    jo, to = _opt(arch, jp, tp)
    ref_opt, port_opt = _ref_leaves(jo), _port_leaves(to)
    assert port_opt == ref_opt
    family = jreg.ARCHS[arch].family
    batches, caches = _dims_of(arch)
    for shape, axes in MESHES:
        jm, tm = _jmesh(shape, axes), AbstractMesh(shape, axes)
        for path, leaf_shape, _ in ref + ref_opt:
            want = jsh.spec_for_path(path, leaf_shape, jsh.FAMILY_RULES[family], jm)
            got = tsh.spec_for_path(path, leaf_shape, tsh.FAMILY_RULES[family], tm)
            assert tuple(got) == tuple(want), (path, shape)
        for b, r in batches:
            assert tuple(tsh.batch_spec(tm, b, r)) == tuple(jsh.batch_spec(jm, b, r))
        for b, s, kv in caches:
            assert tuple(tsh.kv_cache_spec(tm, b, s, kv)) == tuple(jsh.kv_cache_spec(jm, b, s, kv))


def test_rules_are_the_references_regex_for_regex():
    for family, rules in jsh.FAMILY_RULES.items():
        port = tsh.FAMILY_RULES[family]
        assert [p for p, _ in port] == [p for p, _ in rules]
        assert [tuple(s) for _, s in port] == [tuple(s) for _, s in rules]


def test_divisible_suffix_and_sanitize():
    mesh = AbstractMesh((1, 1), ("data", "model"))
    assert tsh.divisible_suffix(("pod", "data"), 16, mesh) == ()  # size-1 axes
    assert tsh._sanitize(tsh.P(("pod", "data"), "model"), (16, 32), mesh) == tsh.P(None, None)
    big = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert tsh.divisible_suffix(("pod", "data"), 16, big) == ("data",)
    assert tsh.divisible_suffix(("pod", "data"), 64, big) == ("pod", "data")
    assert tsh._sanitize(tsh.P(("pod", "data"), "model"), (16, 30), big) == tsh.P("data", None)


def test_batch_spec_divisibility():
    mesh = AbstractMesh((1, 1), ("data", "model"))
    # on a size-1 mesh both forms are equivalent
    assert tsh.batch_spec(mesh, 16, 2) in (tsh.P(None, None), tsh.P("data", None))
    assert tsh.batch_spec(mesh, 15, 1) in (tsh.P(None), tsh.P("data"))
    big = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert tsh.batch_spec(big, 64, 2) == tsh.P(("pod", "data"), None)
    assert tsh.batch_spec(big, 48, 2) == tsh.P(None, None)


def test_a_spec_compares_with_a_partition_spec():
    assert tuple(tsh.P("model", None)) == tuple(PartitionSpec("model", None))
    assert tsh.P() == () and repr(tsh.P("data")) == "P('data',)"


def test_placements_shard_each_named_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert tsh.placements(tsh.P(None, ("pod", "data"), None, None, "model"), mesh) == (
        Shard(1), Shard(1), Shard(4))
    assert tsh.placements(tsh.P("model", None), mesh) == (Replicate(), Replicate(), Shard(0))
    assert tsh.placements(tsh.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements(tsh.P(("data", "pod")), mesh)
    sh = tsh.NamedSharding(mesh, tsh.P(None, ("pod", "data"), None, None, "model"))
    assert sh.shard_shape((35, 128, 7168, 2, 4864)) == (35, 4, 7168, 2, 304)
    with pytest.raises(ValueError, match="does not divide"):
        sh.shard_shape((35, 100, 7168, 2, 4864))
