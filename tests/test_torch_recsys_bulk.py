"""The recsys cells that run at scale: SASRec's, DIN's and MIND's
``serve_bulk`` and ``retrieval_cand`` steps, and DIN's retrieval in chunks.

DIN's one-pass retrieval of a million candidates would need ~103 GB of
activations at the full config, so the port scores the candidates in
chunks (``repro_torch.launch.steps.din_chunk_rows``).  On the CPU, at each
architecture's smoke config, the port's bound steps are held to the
reference's ``repro.launch.steps._recsys_fns`` on the same seeded batches,
the JAX weights carried across by ``params_from_numpy``; the chunk plan is
checked at the full config, and the full-config bundle runs on ``meta``.

Tolerance, f32: ``TOL`` = rtol 1e-5, atol 1e-6, as in
``tests/test_torch_recsys.py`` (the two sides multiply in different
orders; the scores are logits and dot products of magnitude ~1).  A chunk
of DIN's retrieval and the serve function on the same materialised rows
run the same shapes, so they are held bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
JAX_INIT = {"sasrec": jrec.init_sasrec, "din": jrec.init_din, "mind": jrec.init_mind}


def _params(name):
    jp = JAX_INIT[name](jax.random.PRNGKey(0), jreg.get_arch(name).smoke_config)
    return jp, trec.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _reference(name, kind, jp, batch):
    """The reference's serve (``kind`` "serve") or retrieval function, run
    jitted on the port's batch."""
    fns = jsteps._recsys_fns(jreg.get_arch(name), jreg.get_arch(name).smoke_config)
    fn = fns[1] if kind == "serve" else fns[2]
    return np.asarray(jax.jit(fn)(jp, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}))


def _din_step(tp, seed=5):
    arch = treg.get_arch("din")
    return tsteps.build_recsys_step(arch, arch.shape("retrieval_cand"), tp,
                                    torch.Generator().manual_seed(seed), "cpu", smoke=True)


def _chunk_sizes(monkeypatch):
    """The rows of each ``din_forward`` call, recorded."""
    sizes, forward = [], trec.din_forward

    def record(params, batch, cfg):
        sizes.append(batch["target"].shape[0])
        return forward(params, batch, cfg)

    monkeypatch.setattr(trec, "din_forward", record)
    return sizes


@pytest.mark.parametrize("chunk_rows,chunks", [(1000, [1000] * 4 + [96]), (None, [4096])])
def test_din_chunked_retrieval_equals_the_reference(monkeypatch, chunk_rows, chunks):
    """4096 candidates at the smoke config: in chunks of 1000 (a ragged tail
    of 96) and with the default plan (one chunk), within TOL of the
    reference's one pass."""
    jp, tp = _params("din")
    step = _din_step(tp)
    assert step.batch["cands"].shape == (4096,)
    sizes = _chunk_sizes(monkeypatch)
    got = step.fn(step.batch, chunk_rows=chunk_rows)
    assert sizes == chunks
    assert got.shape == (4096,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _reference("din", "retrieval", jp, step.batch), **TOL)


def test_din_retrieval_chunk_equals_serve_on_the_same_rows():
    """A chunk of the retrieval against the serve function on the
    materialised (history, candidate) pairs of that chunk: the same shapes,
    bit for bit."""
    _, tp = _params("din")
    step = _din_step(tp, seed=6)
    arch = treg.get_arch("din")
    serve_fn = tsteps.recsys_fns(arch, arch.smoke_config)[0]
    got = step.fn(step.batch, chunk_rows=1000)
    for lo in (0, 1000, 4000):
        cands = step.batch["cands"][lo:lo + 1000]
        hist = step.batch["hist"].expand(cands.shape[0], -1).contiguous()
        assert torch.equal(got[lo:lo + 1000], serve_fn(tp, {"hist": hist, "target": cands}))


def test_din_chunk_plan_at_the_full_config(monkeypatch):
    """103,200 bytes a row (``din_row_bytes``' derivation): 262,144 rows a
    chunk under the 32 GiB budget, four chunks for a million candidates (a
    tail of 213,568), a chunk and the table well below the card's 80 GB,
    the one pass above it."""
    cfg = treg.get_arch("din").config
    row, rows = tsteps.din_row_bytes(cfg), tsteps.din_chunk_rows(cfg)
    assert row == cfg.seq_len * (5 * 18 + 2 * 80 + 8) * 4 == 103_200
    assert rows == 262_144 == treg.get_arch("din").shape("serve_bulk").dims["batch"]
    c = treg.get_arch("din").shape("retrieval_cand").dims["n_candidates"]
    sizes = [t.shape[0] for t in torch.empty(c, device="meta").split(rows)]
    assert sizes == [262_144] * 3 + [213_568]
    table = cfg.n_items * cfg.embed_dim * 4
    assert rows * row <= tsteps.DIN_CHUNK_BYTES and rows * row + table < 30e9
    assert c * row + table > 80e9
    # a power of two below any budget, and at least one row
    monkeypatch.setattr(tsteps, "DIN_CHUNK_BYTES", 1000 * row)
    assert tsteps.din_chunk_rows(cfg) == 512
    monkeypatch.setattr(tsteps, "DIN_CHUNK_BYTES", 1)
    assert tsteps.din_chunk_rows(cfg) == 1


def test_din_retrieval_bundle_runs_on_meta_at_the_full_config(monkeypatch):
    """``build_step`` for din:retrieval_cand at the full config: the same
    ``model_flops`` as the reference's formula (2 c d), the chunked step
    runs on meta in four chunks, and it counts the one pass's flops."""
    arch = treg.get_arch("din")
    bundle = tsteps.build_step(arch, arch.shape("retrieval_cand"), None)
    assert bundle.model_flops == 2.0 * 1_000_000 * 18
    sizes = _chunk_sizes(monkeypatch)
    counted = {}
    for rows in (None, 1_000_000):
        with FlopCounterMode(display=False) as fc:
            out = bundle.jitted()(*bundle.inputs, chunk_rows=rows)
        counted[rows] = fc.get_total_flops()
        assert out.shape == (1_000_000,) and out.device.type == "meta"
    assert sizes == [262_144] * 3 + [213_568] + [1_000_000]
    assert counted[None] == counted[1_000_000] > 0


@pytest.mark.parametrize("name", ["sasrec", "din", "mind"])
@pytest.mark.parametrize("shape", ["serve_bulk", "retrieval_cand"])
def test_bulk_and_retrieval_steps_equal_the_reference(name, shape):
    """The bound step (``smoke=True``: 64 rows, or 4096 candidates) on the
    CPU against the reference's function on the same seeded batch."""
    arch = treg.get_arch(name)
    jp, tp = _params(name)
    step = tsteps.build_recsys_step(arch, arch.shape(shape), tp,
                                    torch.Generator().manual_seed(len(name)), "cpu", smoke=True)
    got = step.fn(step.batch)
    rows = 64 if shape == "serve_bulk" else 4096
    assert got.shape == (rows,) and torch.isfinite(got).all()
    kind = "serve" if shape == "serve_bulk" else "retrieval"
    np.testing.assert_allclose(got.numpy(), _reference(name, kind, jp, step.batch), **TOL)
