"""The port's recsys training on the CPU against the JAX package's: the
``embedding_bag`` op's gradient, the four losses (``two_tower_loss``,
``sasrec_loss``, ``din_loss``, ``mind_loss``) and their gradients, and one
``build_recsys_step(..., "train_batch", smoke=True)`` step per
architecture against the reference's step run eagerly, with the JAX
weights carried across by ``params_from_numpy`` and the port's batches
given to both.

Tolerances (f32):

* the op's gradient against JAX's: rtol 1e-6, atol 1e-7 (a row's
  contributions summed in other orders); against the plain version's
  autograd gradient: bit for bit (the same sums in the same order);
* losses rtol 1e-5; gradients rtol 1e-4 and atol 1e-6 of the tree's
  largest entry (the backward sums over the batch in other orders);
* after one AdamW step: parameters within 1e-5 (the first step moves each
  entry by about lr times the sign of its gradient, so a gradient within
  rounding of zero may move the other way: at most 2 x 3e-6 with
  ``AdamWConfig()``'s warmup), the first moment as the gradients.
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
from repro.models import recsys as jrec  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_backward,
    embedding_bag_op,
    embedding_bag_plain,
)
from repro_torch.kernels.embedding_bag import kernel as eb_kernel  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402

OP_TOL = dict(rtol=1e-6, atol=1e-7)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6
PARAM_ATOL = 1e-5
RECSYS = ("two-tower-retrieval", "sasrec", "din", "mind")
JAX_INIT = {"two-tower-retrieval": jrec.init_two_tower, "sasrec": jrec.init_sasrec,
            "din": jrec.init_din, "mind": jrec.init_mind}
JAX_LOSS = {"two-tower-retrieval": jrec.two_tower_loss, "sasrec": jrec.sasrec_loss,
            "din": jrec.din_loss, "mind": jrec.mind_loss}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bags(rng, v, b, l):
    """Bags with repeated ids (within a bag and across bags), pads, an
    all-pad bag and a bag of one id."""
    bags = rng.integers(0, v, size=(b, l))
    bags[rng.random((b, l)) < 0.3] = -1
    bags[0] = -1
    bags[1, 1:] = -1
    bags[2] = 3  # one id l times
    bags[3, :2] = 3  # and again in another bag
    bags[4:8, 0] = v - 1
    return bags.astype(np.int32)


def _table_grad(table, bags, w, mode, use_kernel):
    t = table.clone().requires_grad_(True)
    (embedding_bag_op(t, bags, mode, use_kernel=use_kernel) * w).sum().backward()
    return t.grad


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("d", [1, 16, 50])
def test_embedding_bag_gradient_equals_jax(mode, d):
    rng = np.random.default_rng(d)
    table = rng.normal(size=(40, d)).astype(np.float32)
    bags = _bags(rng, 40, 24, 6)
    w = rng.normal(size=(24, d)).astype(np.float32)
    want = jax.grad(lambda t: (jrec.embedding_bag(t, jnp.asarray(bags), mode) * w).sum())(
        jnp.asarray(table))
    before = eb_kernel.launches
    for use_kernel in (True, False):
        got = _table_grad(torch.from_numpy(table), torch.from_numpy(bags),
                          torch.from_numpy(w), mode, use_kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    assert eb_kernel.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_backward_equals_the_plain_autograd_bit_for_bit(mode, dtype):
    """The op's backward and autograd's of the plain version: pads, ids at
    or past V (NaN forward, no gradient), repeated ids; and the backward
    on its own."""
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.normal(size=(30, 8)).astype(np.float32)).to(dtype)
    bags = _bags(rng, 30, 32, 5)
    bags[9, 2], bags[10, 0] = 30, 31  # past the table
    bags = torch.from_numpy(bags)
    w = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32)).to(dtype)
    w[9:11] = 0  # the NaN rows' outputs do not reach the loss
    got = _table_grad(table, bags, w, mode, True)
    want = _table_grad(table, bags, w, mode, False)
    assert got.dtype == dtype and torch.equal(got, want)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(embedding_bag_backward(w, bags, 30, mode).float().numpy(),
                                  got.float().numpy())
    # rows no valid id names get nothing
    named = torch.zeros(30, dtype=torch.bool)
    named[bags[(bags >= 0) & (bags < 30)].long()] = True
    assert bool((got[~named] == 0).all())
    with torch.no_grad():  # NaN for the ids past the table, on both
        torch.testing.assert_close(embedding_bag_op(table, bags, mode),
                                   embedding_bag_plain(table, bags, mode),
                                   rtol=0, atol=0, equal_nan=True)


def _configs(name):
    return jreg.get_arch(name).smoke_config, treg.get_arch(name).smoke_config


def _params(name, jc):
    jp = JAX_INIT[name](jax.random.PRNGKey(0), jc)
    return jp, trec.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _train_batch(name, tc, seed, b=64):
    """A training batch from the port's maker, with history pads and a
    repeated id in every bag kind."""
    _, make_train = tsteps.recsys_train_fns(treg.get_arch(name), tc)
    batch = make_train(b, torch.Generator().manual_seed(seed))
    for key in ("seq", "hist"):
        if key in batch:
            batch[key][:, ::4] = -1
    for key in ("user_feats", "item_feats"):
        if key in batch:
            batch[key][:8, :2] = 5
    return batch


def _assert_grads_close(tg, jg):
    """Within rtol and an atol relative to the tree's largest gradient
    entry (a leaf the loss is invariant to, as DIN's last attention bias
    under its softmax, has a gradient of rounding noise)."""
    fj, ft = _flat(jg), _flat(tg)
    assert fj.keys() == ft.keys()
    atol = GRAD_ATOL_REL * max(np.abs(_np(w)).max() for w in fj.values())
    for key, want in fj.items():
        want = _np(want)
        got = ft[key]
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, key
        np.testing.assert_allclose(_np(got), want, rtol=GRAD_RTOL, atol=atol, err_msg=key)


@pytest.mark.parametrize("name", RECSYS)
def test_losses_and_gradients_equal_jax(name):
    jc, tc = _configs(name)
    jp, tp = _params(name, jc)
    batch = _train_batch(name, tc, seed=1)
    jl, jg = jax.jit(jax.value_and_grad(JAX_LOSS[name]), static_argnums=2)(
        jp, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, jc)
    loss_fn, _ = tsteps.recsys_train_fns(treg.get_arch(name), tc)
    kernels = (True, False) if name == "two-tower-retrieval" else (None,)
    results = []
    for use_kernel in kernels:
        kw = {} if use_kernel is None else {"use_kernel": use_kernel}
        tl, tg = tsteps.value_and_grad(loss_fn)(tp, batch, tc, **kw)
        assert tl.dtype == torch.float32 and bool(torch.isfinite(tl))
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
        _assert_grads_close(tg, jg)
        results.append((tl, tg))
    if len(results) == 2:  # the kernel's backward and the plain autograd one
        (l1, g1), (l0, g0) = results
        assert torch.equal(l1, l0)
        assert all(torch.equal(a, b) for a, b in zip(tcommon.tree_leaves(g1),
                                                    tcommon.tree_leaves(g0)))


@pytest.mark.parametrize("name", RECSYS)
def test_train_step_equals_the_references_step(name):
    """``build_recsys_step(kind="train")``: one step at the smoke config
    (batch 64, AdamW) against the reference's bundle's step, run eagerly,
    on the same weights and batch."""
    jarch, tarch = jreg.get_arch(name), treg.get_arch(name)
    jp, tp = _params(name, jarch.smoke_config)
    step = tsteps.build_recsys_step(tarch, tarch.shape("train_batch"), tp,
                                    torch.Generator().manual_seed(2), device="cpu", smoke=True)
    first = next(iter(step.batch.values()))
    assert first.shape[0] == 64 and step.model_flops > 0
    with make_smoke_mesh() as mesh:
        bundle = jsteps.build_recsys_step(jarch, jarch.shape("train_batch"), mesh, smoke=True)
        assert {k: tuple(s.shape) for k, s in bundle.inputs[2].items()} == \
            {k: tuple(v.shape) for k, v in step.batch.items()}
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in step.batch.items()}
        jp2, js2, jout = bundle.fn(jp, joptim.init_opt_state(jp), jbatch)
    tp2, ts2, tout = step.fn(step.batch)
    assert tp2 is tp and ts2 is step.opt_state and int(ts2.step) == int(js2.step) == 1
    np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), rtol=LOSS_RTOL)
    fw, fg = _flat(jp2), _flat(tcommon.tree_map(lambda t: t, tp2))
    assert fw.keys() == fg.keys()
    for key, w in fw.items():
        np.testing.assert_allclose(_np(fg[key]), _np(w), rtol=GRAD_RTOL, atol=PARAM_ATOL,
                                   err_msg=key)
    _assert_grads_close(ts2.mu, js2.mu)  # the first moment is 0.1 x the gradient
    # a second call continues from the updated state
    _, ts3, out3 = step.fn(step.batch)
    assert int(ts3.step) == 2 and bool(torch.isfinite(out3["loss"]))


def test_two_tower_trains_through_the_op_on_a_wide_config():
    """Two-tower at the full embedding width (256, towers 64-32): the
    loss falls over ten steps on a fixed batch, the kernel path's losses
    and parameters equal the plain path's bit for bit."""
    arch = treg.get_arch("two-tower-retrieval")
    arch = dc.replace(arch, smoke_config=dc.replace(arch.smoke_config, embed_dim=256,
                                                    tower_dims=(64, 32)))
    runs = []
    for use_kernel in (True, False):
        params = trec.init_two_tower(torch.Generator().manual_seed(0), arch.smoke_config)
        step = tsteps.build_recsys_step(arch, arch.shape("train_batch"), params,
                                        torch.Generator().manual_seed(1), device="cpu",
                                        smoke=True)
        losses = [float(step.fn(step.batch, use_kernel=use_kernel)[2]["loss"])
                  for _ in range(10)]
        runs.append((losses, tcommon.tree_leaves(params)))
    (l1, p1), (l0, p0) = runs
    assert l1 == l0 and l1[-1] < l1[0]
    assert all(torch.equal(a, b) for a, b in zip(p1, p0))
