"""The port's recsys serving path on the CPU against the JAX package's: the
four architectures' registry entries, two-tower's towers, and each
architecture's serve and retrieval functions (``repro.launch.steps.
_recsys_fns``), with the JAX weights carried across by
``params_from_numpy`` and the same batches on both sides.

Configurations: each architecture's smoke config, and one two-tower
variant at the full embedding width (``embed_dim`` 256, towers 64-32).
Batches come from the port's own makers (``repro_torch.launch.steps``),
with some history slots turned into pads so the masks are exercised.
Tolerance, f32: rtol 1e-5, atol 1e-6 (the two sides multiply in different
orders; the outputs are dot products of unit vectors and logits of
magnitude ~1).
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
from repro.models import recsys as jrec  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel as eb_kernel  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
RECSYS = ("two-tower-retrieval", "sasrec", "din", "mind")
JAX_INIT = {"two-tower-retrieval": jrec.init_two_tower, "sasrec": jrec.init_sasrec,
            "din": jrec.init_din, "mind": jrec.init_mind}
WIDE = dict(embed_dim=256, tower_dims=(64, 32))


def _configs(name, wide=False):
    """``(jax config, port config)``: the smoke config, or two-tower's wide
    variant."""
    jc, tc = jreg.get_arch(name).smoke_config, treg.get_arch(name).smoke_config
    if wide:
        jc, tc = dc.replace(jc, **WIDE), dc.replace(tc, **WIDE)
    return jc, tc


def _params(name, jc):
    jp = JAX_INIT[name](jax.random.PRNGKey(0), jc)
    return jp, trec.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(name, tc, kind, seed):
    """A batch from the port's maker on the CPU (64 rows, or 512
    candidates), with every fifth history slot a pad."""
    _, _, make_serve, make_retr = tsteps.recsys_fns(treg.get_arch(name), tc)
    gen = torch.Generator().manual_seed(seed)
    batch = make_serve(64, gen) if kind == "serve" else make_retr(512, gen)
    for key in ("seq", "hist"):
        if key in batch:
            batch[key][:, ::5] = -1
    return batch


def _run_both(name, jc, tc, kind, seed):
    jp, tp = _params(name, jc)
    jfns = jsteps._recsys_fns(jreg.get_arch(name), jc)
    tfns = tsteps.recsys_fns(treg.get_arch(name), tc)
    jfn, tfn = (jfns[1], tfns[0]) if kind == "serve" else (jfns[2], tfns[1])
    batch = _batch(name, tc, kind, seed)
    want = jax.jit(jfn)(jp, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    return np.asarray(want), tfn(tp, batch).numpy()


@pytest.mark.parametrize("name", RECSYS)
def test_recsys_configs_equal_the_jax_registrys(name):
    ja, ta = jreg.get_arch(name), treg.get_arch(name)
    assert (ta.name, ta.family, ta.notes) == (ja.name, ja.family, ja.notes)
    assert [dc.asdict(s) for s in ta.shapes] == [dc.asdict(s) for s in ja.shapes]
    for jc, tc in ((ja.config, ta.config), (ja.smoke_config, ta.smoke_config)):
        assert type(tc).__name__ == type(jc).__name__
        assert [f.name for f in dc.fields(tc)] == [f.name for f in dc.fields(jc)]
        for f in dc.fields(jc):
            a, b = getattr(jc, f.name), getattr(tc, f.name)
            if f.name == "dtype":
                assert (a, b) == (jnp.float32, torch.float32)
            else:
                assert a == b, f.name


def test_recsys_shapes_and_config_modules():
    from repro_torch.configs import din, mind, sasrec, two_tower_retrieval

    assert [dc.asdict(s) for s in treg.RECSYS_SHAPES] == [dc.asdict(s) for s in jreg.RECSYS_SHAPES]
    for mod, name in ((two_tower_retrieval, "two-tower-retrieval"), (sasrec, "sasrec"),
                      (din, "din"), (mind, "mind")):
        arch = treg.get_arch(name)
        assert (mod.CONFIG, mod.SMOKE_CONFIG) == (arch.config, arch.smoke_config)
        assert set(mod.SHAPES) == {s.name for s in treg.RECSYS_SHAPES}


@pytest.mark.parametrize("name", RECSYS)
def test_init_has_the_references_tree(name):
    """Seeded weights from a torch.Generator: the reference's names, shapes
    and dtypes; tables at std 0.05 within two std."""
    jc, tc = _configs(name)
    want = jax.eval_shape(lambda: JAX_INIT[name](jax.random.PRNGKey(0), jc))
    got = tsteps.RECSYS_INIT[name](torch.Generator().manual_seed(0), tc)
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    assert tree_g == tree_w
    for w, g in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    table = got["item_table"]
    assert float(table.abs().max()) <= 0.1 and 0.03 < float(table.std()) < 0.05
    assert trec.param_count(got) == sum(int(np.prod(w.shape)) for w in flat_w)


def test_params_from_numpy_is_bit_exact():
    jc, _ = _configs("two-tower-retrieval")
    jp, tp = _params("two-tower-retrieval", jc)
    for w, g in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(tp)):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("wide", [False, True])
def test_two_tower_towers_equal_the_jax_ones(wide):
    jc, tc = _configs("two-tower-retrieval", wide)
    jp, tp = _params("two-tower-retrieval", jc)
    batch = _batch("two-tower-retrieval", tc, "serve", seed=1)
    for jfn, tfn, key in ((jrec.two_tower_user, trec.two_tower_user, "user_feats"),
                          (jrec.two_tower_item, trec.two_tower_item, "item_feats")):
        want = jfn(jp, jnp.asarray(batch[key].numpy()), jc)
        got = tfn(tp, batch[key], tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, rtol=1e-5)
        assert torch.equal(tfn(tp, batch[key], tc, use_kernel=False), got)


@pytest.mark.parametrize("name,wide", [(n, False) for n in RECSYS]
                         + [("two-tower-retrieval", True)])
@pytest.mark.parametrize("kind", ["serve", "retrieval"])
def test_serve_and_retrieval_equal_the_jax_ones(name, wide, kind):
    jc, tc = _configs(name, wide)
    want, got = _run_both(name, jc, tc, kind, seed=len(name) + wide)
    assert got.shape == want.shape == ((64,) if kind == "serve" else (512,))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_build_recsys_step_draws_real_ids_at_the_shapes_sizes():
    arch = treg.get_arch("two-tower-retrieval")
    tc = arch.smoke_config
    params = trec.init_two_tower(torch.Generator().manual_seed(0), tc)
    gen = torch.Generator().manual_seed(3)
    before = eb_kernel.launches
    for shape in ("serve_p99", "retrieval_cand"):
        step = tsteps.build_recsys_step(arch, arch.shape(shape), params, gen, "cpu", smoke=True)
        rows = 64 if shape == "serve_p99" else 4096
        for key, high, l in (("user_feats", tc.n_users, 8), ("item_feats", tc.n_items, 4),
                             ("cand_feats", tc.n_items, 4)):
            if key not in step.batch:
                continue
            bags = step.batch[key]
            assert bags.dtype == torch.int32 and bags.shape[1] == l
            length = (bags >= 0).sum(1)
            assert int(length.min()) >= 1 and int(length.max()) <= l
            # the ids first, the pads after them, every id in the table
            assert torch.equal(bags >= 0, torch.arange(l) < length[:, None])
            assert int(bags.max()) < high
            if key != "user_feats" or shape == "serve_p99":
                assert bags.shape[0] == rows
        out = step.fn(step.batch)
        assert out.shape == (rows,) and torch.isfinite(out).all()
        assert torch.equal(step.fn(step.batch, use_kernel=False), out)
    assert eb_kernel.launches == before  # the CPU runs the plain version
    for name in ("sasrec", "din", "mind"):
        arch = treg.get_arch(name)
        params = tsteps.RECSYS_INIT[name](torch.Generator().manual_seed(0), arch.smoke_config)
        step = tsteps.build_recsys_step(arch, arch.shape("serve_p99"), params, gen, "cpu",
                                        smoke=True)
        hist = step.batch.get("seq", step.batch.get("hist"))
        assert hist.shape == (64, arch.smoke_config.seq_len) and int(hist.min()) >= 0
        assert torch.isfinite(step.fn(step.batch)).all()


def test_build_recsys_step_refuses_what_is_not_ported():
    """Training is ported (tests/test_torch_recsys_train.py); what is
    refused now is a family that is not recsys and an unknown kind."""
    arch = treg.get_arch("din")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="unknown step kind"):
        tsteps.build_recsys_step(arch, treg.ShapeSpec("x", "eval", {"batch": 4}), {}, gen, "cpu")
    lm = treg.get_arch("gemma-2b")
    with pytest.raises(ValueError, match="not a recsys"):
        tsteps.build_recsys_step(lm, lm.shapes[0], {}, gen, "cpu")
