"""The port's EmbeddingBag on the CPU (its plain PyTorch version) against the
JAX package's: the Pallas kernel in interpret mode
(``embedding_bag_op(..., use_kernel=True, interpret=True)``), the model's
substrate ``repro.models.recsys.embedding_bag`` and the flat oracle
``embedding_bag_ref``.

Tolerances:

* against the model's substrate: equal, in f32 and bf16, for ``sum``,
  ``mean`` and ``max`` (both sum each bag in f32 in slot order and round
  once to the table's dtype), with the reference jitted as its steps run
  it.  That holds for the bags tested here, of up to 16 slots (two-tower's
  are 8 and 4): on longer ones XLA's CPU reduction may sum in another order
  (from 24 slots under jit in f32, measured), an f32 ulp or so apart;
* against the JAX op: equal in f32; in bf16 the reference's own 2e-2
  (rtol and atol, ``tests/test_kernels.py``), since its Pallas kernel adds
  the rows in bf16 and so rounds every add.

The CUDA kernel itself runs only on a card: ``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.embedding_bag.ops import embedding_bag_op as jax_op  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro_torch.kernels import embedding_bag_op  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_plain,
    embedding_bag_ref,
    kernel,
)
from repro_torch.models import recsys as trec  # noqa: E402

SWEEP = [(50, 128, 8, 5), (200, 256, 16, 9), (33, 128, 4, 3)]
jax_model = jax.jit(jrec.embedding_bag, static_argnums=2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed, v, d, b, l):
    """A table and bags drawn as ``tests/test_kernels.py`` draws them: pads
    (-1) anywhere in a bag."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(v, d)).astype(np.float32),
            rng.integers(-1, v, size=(b, l)).astype(np.int32))


def _both(table, bags, dtype):
    jdt, tdt = DTYPES[dtype]
    return ((jnp.asarray(table).astype(jdt), jnp.asarray(bags)),
            (torch.from_numpy(table).to(tdt), torch.from_numpy(bags)))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("v,d,b,l", SWEEP)
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_op_equals_the_jax_pallas_kernel(v, d, b, l, mode, dtype):
    (jt, jb), (tt, tb) = _both(*_case(v * 31 + d + l, v, d, b, l), dtype)
    want = jax_op(jt, jb, mode=mode, use_kernel=True, interpret=True)
    got = embedding_bag_op(tt, tb, mode)
    assert got.dtype == tt.dtype and got.shape == (b, d)
    if dtype == "float32":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("v,d,b,l", SWEEP + [(1000, 256, 64, 8), (5000, 256, 512, 4),
                                           (700, 18, 33, 16)])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_model_substrate_equals_the_jax_models(v, d, b, l, mode, dtype):
    (jt, jb), (tt, tb) = _both(*_case(v + d * 7 + b, v, d, b, l), dtype)
    want = jax_model(jt, jb, mode)
    got = trec.embedding_bag(tt, tb, mode)
    assert got.dtype == tt.dtype
    np.testing.assert_array_equal(_np(got), _np(want))


def _edge_cases():
    """``(label, table, bags)``: all-pad bags, a bag of one, repeated ids,
    the last row, an id past the table (NaN, as jnp.take fills it), widths
    off the 32-lane grid, B = 1 and L = 1."""
    rng = np.random.default_rng(7)
    cases = []
    for d in (18, 50, 64, 256):
        v = 97
        table = rng.normal(size=(v, d)).astype(np.float32)
        bags = rng.integers(0, v, size=(12, 6)).astype(np.int32)
        bags[0] = -1  # all pads
        bags[1, 1:] = -1  # a bag of one
        bags[2] = 5  # one id six times
        bags[3, ::2] = v - 1  # the last row, between other ids
        bags[4, 3:] = -7  # any negative id is a pad
        bags[5, 2] = v  # past the table
        cases.append((f"D={d}", table, bags))
    table = rng.normal(size=(40, 64)).astype(np.float32)
    cases.append(("B=1", table, np.array([[3, -1, 39, 3]], np.int32)))
    cases.append(("L=1", table, rng.integers(-1, 40, size=(9, 1)).astype(np.int32)))
    return cases


@pytest.mark.parametrize("case", range(len(_edge_cases())))
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_edge_cases_equal_the_jax_model(case, mode, dtype):
    label, table, bags = _edge_cases()[case]
    (jt, jb), (tt, tb) = _both(table, bags, dtype)
    got = embedding_bag_op(tt, tb, mode)
    np.testing.assert_array_equal(_np(got), _np(jax_model(jt, jb, mode)), err_msg=label)
    pads = (bags < 0).all(axis=1)
    assert (_np(got)[pads] == 0).all()
    assert np.isnan(_np(got)[(bags >= table.shape[0]).any(axis=1)]).all()
    # int64 ids give the same bits
    assert torch.equal(embedding_bag_op(tt, tb.long(), mode).view(torch.int16 if
                       dtype == "bfloat16" else torch.int32),
                       got.view(torch.int16 if dtype == "bfloat16" else torch.int32))


def test_empty_shapes():
    table = torch.randn(10, 8)
    assert embedding_bag_op(table, torch.zeros((0, 3), dtype=torch.int32)).shape == (0, 8)
    out = embedding_bag_op(table, torch.zeros((4, 0), dtype=torch.int32), "mean")
    assert out.shape == (4, 8) and (out == 0).all()


def test_flat_ref_equals_the_jax_oracle_on_the_manual_case():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(20, 128)).astype(np.float32)
    idx = np.array([3, 5, 5, 7, 0], np.int32)
    seg = np.array([0, 0, 1, 1, 2], np.int32)
    for mode in ("sum", "mean"):
        want = jax_ref(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg), 4, mode=mode)
        got = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(idx),
                                torch.from_numpy(seg), 4, mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(idx),
                            torch.from_numpy(seg), 3)
    np.testing.assert_allclose(got[0].numpy(), table[3] + table[5], rtol=1e-6)


def test_flat_ref_equals_the_plain_bags():
    """The flat contract over a bag layout's valid ids (ascending segments)
    is the plain version over the bags."""
    table, bags = _case(3, 300, 64, 40, 7)
    flat = bags.reshape(-1)
    seg = np.repeat(np.arange(40), 7)[flat >= 0]
    for mode in ("sum", "mean"):
        got = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(flat[flat >= 0]),
                                torch.from_numpy(seg), 40, mode=mode)
        want = embedding_bag_plain(torch.from_numpy(table), torch.from_numpy(bags), mode)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_wrapper_runs_the_plain_version_on_the_cpu_and_rejects_what_the_kernel_does_not_take():
    table, bags = (torch.from_numpy(a) for a in _case(1, 30, 32, 5, 4))
    before = kernel.launches
    assert torch.equal(kernel.embedding_bag(table, bags, "mean"),
                       embedding_bag_plain(table, bags, "mean"))
    assert torch.equal(embedding_bag_op(table, bags, "sum", use_kernel=False),
                       embedding_bag_plain(table, bags, "sum"))
    assert kernel.launches == before  # CPU calls launch nothing
    with pytest.raises(ValueError, match="mode"):
        kernel.embedding_bag(table, bags, "max")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel.embedding_bag(table.double(), bags)
    with pytest.raises(TypeError, match="int32 or int64"):
        kernel.embedding_bag(table, bags.short())
    with pytest.raises(ValueError, match="contiguous"):
        kernel.embedding_bag(table.t(), bags)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.embedding_bag(table, bags.t())
    with pytest.raises(ValueError, match=r"\(V, D\)"):
        kernel.embedding_bag(table, bags[0])
    with pytest.raises(ValueError, match="rows and columns"):
        kernel.embedding_bag(table[:0], bags)
