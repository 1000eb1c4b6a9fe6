"""The port's topic-score op on the CPU (its plain PyTorch version) against
the JAX package's: the Pallas kernel in interpret mode
(``topic_score_op(..., use_kernel=True, interpret=True)``) and the jnp
oracle ``topic_score_ref``.

Inputs are drawn as ``tests/test_kernels.py`` draws them, on its five sweep
shapes, with its tolerances: scores rtol 1e-4 (atol 1e-3), ``top`` exact,
confidences rtol 1e-4 (atol 1e-4).  The CUDA kernel itself runs only on a
card: ``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.topic_score.ops import topic_score_op as jax_op  # noqa: E402
from repro.kernels.topic_score.ref import topic_score_ref  # noqa: E402
from repro_torch.kernels.topic_score import kernel as ts_kernel  # noqa: E402
from repro_torch.kernels.topic_score import topic_score_op, topic_score_plain  # noqa: E402

SHAPES = [(4, 300, 37), (64, 1024, 500), (256, 513, 96), (8, 128, 8), (130, 640, 200)]


def _case(seed, b, v, k):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(0.05, size=(b, v)).astype(np.float32)
    counts[:, 0] += 1.0  # avoid degenerate empty rows
    lpt = np.log(rng.dirichlet(np.ones(v) * 0.1, size=k).T + 1e-12).astype(np.float32)
    return counts, np.ascontiguousarray(lpt)


def _port(counts, lpt):
    return [x.numpy() for x in topic_score_op(torch.from_numpy(counts), torch.from_numpy(lpt))]


def _close(got, want, conf_rows=slice(None)):
    s1, t1, c1 = got
    s0, t0, c0 = (np.asarray(x) for x in want)
    np.testing.assert_allclose(s1, s0, rtol=1e-4, atol=1e-3)
    assert t1.dtype == np.int32 and np.array_equal(t1, t0)
    np.testing.assert_allclose(c1[conf_rows], c0[conf_rows], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,v,k", SHAPES)
def test_plain_version_equals_the_jax_kernel_and_oracle(b, v, k):
    counts, lpt = _case(b * 31 + k, b, v, k)
    before = ts_kernel.launches
    got = _port(counts, lpt)
    assert ts_kernel.launches == before  # the CPU runs the plain version
    assert got[0].shape == (b, k) and got[1].shape == (b,) and got[2].shape == (b,)
    _close(got, topic_score_ref(jnp.asarray(counts), jnp.asarray(lpt)))
    _close(got, jax_op(jnp.asarray(counts), jnp.asarray(lpt), use_kernel=True, interpret=True))


@pytest.mark.parametrize("b,v,k", [(6, 300, 37), (9, 128, 8)])
def test_all_zero_rows_and_exact_ties(b, v, k):
    """An all-zero row scores 0 everywhere: top 0, conf 1/K.  Two identical
    topic columns tie exactly and the lower index wins.

    The JAX op pads K to a multiple of 128 with -1e9 columns, which score 0
    on an all-zero row, so its softmax there is 1/K_padded: its confidence
    is compared on the non-empty rows only (the oracle's is 1/K)."""
    counts, lpt = _case(k, b, v, k)
    counts[::3] = 0.0
    lpt[:, 2] = lpt[:, 5] = lpt.max(axis=1)  # likeliest for every word
    got = _port(counts, lpt)
    zero = np.arange(0, b, 3)
    assert np.all(got[0][zero] == 0) and np.all(got[1][zero] == 0)
    np.testing.assert_allclose(got[2][zero], 1.0 / k, rtol=1e-6)
    assert np.array_equal(got[0][:, 2], got[0][:, 5])
    full = np.setdiff1d(np.arange(b), zero)
    assert np.all(got[1][full] == 2)
    _close(got, topic_score_ref(jnp.asarray(counts), jnp.asarray(lpt)))
    _close(got, jax_op(jnp.asarray(counts), jnp.asarray(lpt), use_kernel=True, interpret=True),
           conf_rows=full)


def test_op_takes_views_and_the_wrapper_checks_its_operands():
    counts, lpt = _case(1, 12, 40, 5)
    c, t = torch.from_numpy(counts), torch.from_numpy(lpt)
    want = topic_score_plain(c, t)
    got = topic_score_op(c.t().contiguous().t(), t.t().contiguous().t())  # non-contiguous views
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        ts_kernel.topic_score(c.double(), t)
    with pytest.raises(ValueError):
        ts_kernel.topic_score(c[:, :-1].contiguous(), t)
    with pytest.raises(ValueError):
        ts_kernel.topic_score(c, t[:, :0].contiguous())
    s, top, conf = topic_score_op(c[:0], t)
    assert s.shape == (0, 5) and top.shape == (0,) and conf.shape == (0,)


@pytest.mark.parametrize("k,acc", [(1, 1), (31, 1), (32, 1), (33, 2), (96, 3), (500, 16),
                                   (512, 16), (513, 16), (2000, 16)])
def test_accumulators_per_lane(k, acc):
    """One accumulator a lane per 32 topics, at most MAX_ACC: a wider K is
    swept in passes of 32 * acc topics."""
    assert ts_kernel.acc_count(k) == acc
    assert 32 * acc >= min(k, 32 * ts_kernel.MAX_ACC)


@pytest.mark.parametrize("ptr,v,vec", [(0, 4096, 4), (256, 4096, 4), (4, 4096, 1), (8, 1000, 1),
                                       (0, 4097, 1), (0, 130, 1)])
def test_load_width(ptr, v, vec):
    """16-byte loads only when every row of the counts starts 16-byte
    aligned."""
    assert ts_kernel.vec_width(ptr, v) == vec
