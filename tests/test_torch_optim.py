"""The port's optimizers (``repro_torch.train.optim``) and the shared loss
and norm (``repro_torch.models.common``) on the CPU against the JAX
package's, on seeded numpy trees carried to both sides.

Each case chains three updates from the same parameters, gradients and
state; the gradients are scaled so the global-norm clip is active.
Tolerances:

* f32 leaves: rtol 1e-6, atol 1e-7 on parameters and states.  Both sides
  evaluate the reference's expressions in the same order in f32; they can
  differ by an ulp where a scalar is computed by a different ``pow`` (the
  bias corrections, Adafactor's ``beta2``) or a sum runs in another order
  (the global norm, Adafactor's row and column means).
* bf16 leaves: the update is computed in f32 and rounded to bf16, so a
  parameter within an ulp of a rounding boundary may round the other way:
  one bf16 ulp (rtol 2**-7) on the parameters, f32's tolerance on the
  moments (which see the bf16 parameters only through weight decay).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jcommon  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

F32_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-7)

#: a tree with a stacked matrix, a vector, a tiny-penultimate-axis leaf
#: (merged by _factored_shape), a list and a scalar
SHAPES = {"w": (3, 16, 8), "b": (8,), "moe": (2, 6, 2, 5), "blocks": [(4, 4), (5,)], "s": ()}


def _tree(rng, dtype, scale=1.0):
    def leaf(shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    tree = {k: [leaf(s) for s in v] if isinstance(v, list) else leaf(v) for k, v in SHAPES.items()}
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)), tree)


def _to_torch(tree):
    return tcommon.tree_map(lambda a: tcommon.tensor_from_numpy(a, "cpu"), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_trees_close(got, want, tol):
    g, w = tcommon.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), _np(b), **tol)


def _chain(optimizer, dtype, seed):
    """Three chained updates on both sides from the same tree, each with
    its own seeded gradients (norm ~40: the clip is active)."""
    rng = np.random.default_rng(seed)
    params = _tree(rng, dtype)
    grads = [_tree(rng, dtype, scale=5.0) for _ in range(3)]
    if optimizer == "adamw":
        cfg = dict(lr=1e-2, warmup_steps=2)
        jcfg, tcfg = joptim.AdamWConfig(**cfg), toptim.AdamWConfig(**cfg)
        jinit, jupd, tinit, tupd = (joptim.init_opt_state, joptim.apply_updates,
                                    toptim.init_opt_state, toptim.apply_updates)
    else:
        cfg = dict(lr=1e-2, warmup_steps=2, weight_decay=0.01)
        jcfg, tcfg = joptim.AdafactorConfig(**cfg), toptim.AdafactorConfig(**cfg)
        jinit, jupd, tinit, tupd = (joptim.init_adafactor_state, joptim.adafactor_updates,
                                    toptim.init_adafactor_state, toptim.adafactor_updates)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _to_torch(params)
    js, ts = jinit(jp), tinit(tp)
    for g in grads:
        assert float(jcommon.global_norm(jax.tree.map(jnp.asarray, g))) > 10.0
        jp, js = jupd(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts = tupd(tp, _to_torch(g), ts, tcfg)
    return jp, js, tp, ts


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_apply_updates_three_chained_steps_equal_jax(dtype):
    jp, js, tp, ts = _chain("adamw", dtype, seed=0)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    _assert_trees_close(tp, jp, F32_TOL if dtype == jnp.float32 else BF16_TOL)
    for leaf in tcommon.tree_leaves(tp):
        assert leaf.dtype == (torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    for got, want in ((ts.mu, js.mu), (ts.nu, js.nu)):
        assert all(m.dtype == torch.float32 for m in tcommon.tree_leaves(got))
        _assert_trees_close(got, want, F32_TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_adafactor_updates_three_chained_steps_equal_jax(dtype):
    jp, js, tp, ts = _chain("adafactor", dtype, seed=1)
    assert int(ts.step) == int(js.step) == 3
    _assert_trees_close(tp, jp, F32_TOL if dtype == jnp.float32 else BF16_TOL)
    # the stats: "row"/"col" for factored leaves, "full" for vectors
    flat_j = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(js.stats)[0]}
    flat_t = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(ts.stats)[0]}
    assert flat_j.keys() == flat_t.keys()
    for key, want in flat_j.items():
        np.testing.assert_allclose(_np(flat_t[key]), _np(want), **F32_TOL, err_msg=key)


def test_factored_shape_equals_the_references():
    for shape in ((4, 8, 16, 2, 32), (16, 32), (7,), (), (3, 5, 7), (2, 6, 2, 5), (9, 3, 4)):
        assert toptim._factored_shape(shape) == joptim._factored_shape(shape), shape
    assert toptim._factored_shape((4, 8, 16, 2, 32)) == ((4, 8, 32, 32), True)


def test_updates_are_in_place_and_without_clip_or_warmup():
    """The port updates the caller's tensors; with no clip the gradients
    are left as they are; the schedule's warmup ramps the step size."""
    rng = np.random.default_rng(2)
    params, grads = _tree(rng, jnp.float32), _tree(rng, jnp.float32)
    tp, tg = _to_torch(params), _to_torch(grads)
    before = [p.clone() for p in tcommon.tree_leaves(tp)]
    g_before = [g.clone() for g in tcommon.tree_leaves(tg)]
    state = toptim.init_opt_state(tp)
    cfg = toptim.AdamWConfig(clip_norm=None, warmup_steps=1)
    out, new = toptim.apply_updates(tp, tg, state, cfg)
    assert out is tp and new.mu is state.mu and int(state.step) == 1
    assert all(not torch.equal(a, b) for a, b in zip(before, tcommon.tree_leaves(tp)))
    assert all(torch.equal(a, b) for a, b in zip(g_before, tcommon.tree_leaves(tg)))
    jp, _ = joptim.apply_updates(jax.tree.map(jnp.asarray, params),
                                 jax.tree.map(jnp.asarray, grads),
                                 joptim.init_opt_state(jax.tree.map(jnp.asarray, params)),
                                 joptim.AdamWConfig(clip_norm=None, warmup_steps=1))
    _assert_trees_close(tp, jp, F32_TOL)
    assert float(toptim._schedule(toptim.AdamWConfig(warmup_steps=100), torch.tensor(9))) == \
        pytest.approx(3e-5)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_opt_state_from_numpy_is_bit_exact(kind):
    rng = np.random.default_rng(3)
    params = jax.tree.map(jnp.asarray, _tree(rng, jnp.bfloat16))
    grads = jax.tree.map(jnp.asarray, _tree(rng, jnp.bfloat16, scale=3.0))
    if kind == "adamw":
        _, js = joptim.apply_updates(params, grads, joptim.init_opt_state(params),
                                     joptim.AdamWConfig())
    else:
        _, js = joptim.adafactor_updates(params, grads, joptim.init_adafactor_state(params),
                                         joptim.AdafactorConfig())
    ts = toptim.opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert type(ts).__name__ == type(js).__name__ and ts._fields == js._fields
    flat_j = jax.tree_util.tree_flatten_with_path(js)[0]
    flat_t = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(ts)[0]}
    for key, want in flat_j:
        got = flat_t[jax.tree_util.keystr(key)]
        assert got.dtype in (torch.float32, torch.int32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_global_norm_equal_jax(masked):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = tcommon.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    tree = _tree(rng, jnp.float32)
    np.testing.assert_allclose(float(tcommon.global_norm(_to_torch(tree))),
                               float(jcommon.global_norm(tree)), rtol=1e-6)
