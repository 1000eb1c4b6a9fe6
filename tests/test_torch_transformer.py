"""The port's LM serving path on the CPU against the JAX package's:
``forward``, ``prefill``, chained ``decode_step``s and the serving CLI's LM
back end, with the JAX ``init_params`` weights carried across by
``params_from_numpy``.

Variants are ``tests/test_models.py``'s dense ones (dense, mqa, gemma2ish
with local/global layers, both softcaps, post norms and a query scale,
qkv_bias), in f32, plus a chunked one (``q_chunk`` 8 over 20 tokens and a
window of 6: the port's query chunks, ragged tail included).  Tolerances:

* f32: rtol 1e-5, atol 2e-5 on logits of magnitude up to ~25 (measured:
  at most 5.3e-6 apart; the two sum in different orders), 1e-5 on the K/V
  caches;
* bf16 (gemma-2b's smoke config in bf16): every intermediate is rounded to
  8 significant bits, and XLA's CPU backend keeps some fused elementwise
  chains in f32 where torch rounds each op, so about half the logits
  differ by a bf16 rounding of an intermediate: rtol 2**-6, atol 2**-4,
  and the mean absolute difference below 2e-2 (measured 0.0127).
"""
import dataclasses as dc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=2.0**-6, atol=2.0**-4)


def _tiny(**over):
    base = dict(
        n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
        vocab_size=128, dtype=jnp.float32, q_chunk=None, remat=False,
    )
    base.update(over)
    return jtf.TransformerConfig(**base)


VARIANTS = {
    "dense": {},
    "mqa": dict(n_kv_heads=1),
    "gemma2ish": dict(
        attn_pattern="local_global", window=16, attn_logit_softcap=50.0,
        final_logit_softcap=30.0, post_norms=True, embed_scale=True,
        tie_embeddings=True, activation="gelu", query_scale=0.3,
    ),
    "qkv_bias": dict(qkv_bias=True),
    "chunked_local": dict(attn_pattern="local_global", window=6, q_chunk=8),
}


def port_config(jcfg):
    """The port's config with the reference's fields (torch dtype)."""
    kw = {f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)}
    kw["dtype"] = DTYPES[jcfg.dtype]
    return ttf.TransformerConfig(**kw)


def _models(jcfg):
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    ported = ttf.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return params, ported, port_config(jcfg)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)
    if tol is BF16_TOL:
        assert np.abs(got - want).mean() < 2e-2


def _cases():
    out = [(name, _tiny(**over), F32_TOL) for name, over in VARIANTS.items()]
    smoke = jreg.get_arch("gemma-2b").smoke_config
    out.append(("gemma-2b-smoke-bf16", dc.replace(smoke, dtype=jnp.bfloat16), BF16_TOL))
    return out


CASES = {name: (cfg, tol) for name, cfg, tol in _cases()}


def _tokens(seed, cfg, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_equals_jax(name):
    jcfg, tol = CASES[name]
    jp, tp, tcfg = _models(jcfg)
    tok = _tokens(1, jcfg, (2, 20))
    want, _ = jtf.forward(jp, jnp.asarray(tok), jcfg)
    got, aux = ttf.forward(tp, torch.from_numpy(tok), tcfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_and_three_decode_steps_equal_jax(name):
    jcfg, tol = CASES[name]
    cache_tol = tol if tol is BF16_TOL else dict(rtol=1e-5, atol=1e-5)
    jp, tp, tcfg = _models(jcfg)
    tok = _tokens(2, jcfg, (2, 20))
    lj, cj = jtf.prefill(jp, jnp.asarray(tok), jcfg, max_len=24)
    lt, ct = ttf.prefill(tp, torch.from_numpy(tok), tcfg, max_len=24)
    _close(lt, lj, tol)
    for key in ("k", "v"):
        _close(ct[key], cj[key], cache_tol)
    assert ct["len"].dtype == torch.int32 and int(ct["len"]) == int(cj["len"]) == 20
    before = da_kernel.launches
    for step in range(3):
        nxt = _tokens(10 + step, jcfg, (2, 1))
        lj, cj = jtf.decode_step(jp, cj, jnp.asarray(nxt), jcfg)
        lt, ct = ttf.decode_step(tp, ct, torch.from_numpy(nxt), tcfg)
        _close(lt, lj, tol)
        for key in ("k", "v"):
            _close(ct[key], cj[key], cache_tol)
        assert int(ct["len"]) == int(cj["len"]) == 21 + step
    assert da_kernel.launches == before  # the CPU runs the plain decode attention


def test_decode_past_the_cache_end_clamps_like_jax():
    """A write at cur >= max_len lands on the last slot (the reference's
    dynamic_update_slice clamps its start), and the query attends to every
    slot; on the local layers of gemma2ish the window then lies past the
    cache and masks every slot (a uniform softmax)."""
    jcfg = dc.replace(_tiny(**VARIANTS["gemma2ish"]), window=3)
    jp, tp, tcfg = _models(jcfg)
    tok = _tokens(3, jcfg, (2, 8))
    _, cj = jtf.prefill(jp, jnp.asarray(tok), jcfg)  # max_len = 8: full
    _, ct = ttf.prefill(tp, torch.from_numpy(tok), tcfg)
    for step in range(4):
        nxt = _tokens(20 + step, jcfg, (2, 1))
        lj, cj = jtf.decode_step(jp, cj, jnp.asarray(nxt), jcfg)
        lt, ct = ttf.decode_step(tp, ct, torch.from_numpy(nxt), tcfg)
        _close(lt, lj, F32_TOL)
        for key in ("k", "v"):
            _close(ct[key], cj[key], dict(rtol=1e-5, atol=1e-5))
    assert int(ct["len"]) == 12


def test_decode_step_with_the_plain_attention_equals_the_op():
    jcfg = _tiny(**VARIANTS["gemma2ish"])
    _, tp, tcfg = _models(jcfg)
    tok = torch.from_numpy(_tokens(4, jcfg, (2, 10)))
    nxt = torch.from_numpy(_tokens(5, jcfg, (2, 1)))
    _, c1 = ttf.prefill(tp, tok, tcfg, max_len=12)
    _, c2 = ttf.prefill(tp, tok, tcfg, max_len=12)
    l1, _ = ttf.decode_step(tp, c1, nxt, tcfg)
    l2, _ = ttf.decode_step(tp, c2, nxt, tcfg, use_kernel=False)
    assert torch.equal(l1, l2)


def test_lm_backend_ids_equal_the_jax_clis():
    """The serving CLI's back end (``launch/serve.py:341-353``) on gemma-2b's
    smoke config with PRNGKey(0) weights: the same doc ids for the same
    query ids, large ids included."""
    arch = jreg.get_arch("gemma-2b")
    mcfg = arch.smoke_config
    params = jtf.init_params(jax.random.PRNGKey(0), mcfg)

    @jax.jit
    def model_scores(tokens):
        logits, _ = jtf.forward(params, tokens, mcfg)
        return jax.lax.top_k(logits[:, -1], 8)[1]

    qids = np.concatenate([np.arange(40), np.random.default_rng(6).integers(0, 68_600_000, 40)])
    tokens = (qids[:, None] * 31 + np.arange(8)[None, :]) % mcfg.vocab_size
    want = np.asarray(model_scores(jnp.asarray(tokens, jnp.int32)), np.int32)
    assert np.array_equal(tserve.query_tokens(qids, mcfg.vocab_size), tokens)
    backend = tserve.lm_backend(
        ttf.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
        treg.get_arch("gemma-2b").smoke_config, value_dim=8, device="cpu",
    )
    got = backend(qids)
    assert got.dtype == np.int32 and got.shape == (80, 8)
    assert np.array_equal(got, want)


def test_lm_backend_graph_max_runs_eagerly_on_the_cpu():
    """``graph_max`` captures CUDA graphs only on a card: on the CPU the
    back end answers as the eager one does."""
    mcfg = treg.get_arch("gemma-2b").smoke_config
    params = ttf.init_params(torch.Generator().manual_seed(0), mcfg)
    qids = np.random.default_rng(7).integers(0, 68_600_000, 50)
    eager = tserve.lm_backend(params, mcfg, value_dim=8, device="cpu")
    graphed = tserve.lm_backend(params, mcfg, value_dim=8, device="cpu", graph_max=64)
    assert np.array_equal(graphed(qids), eager(qids))


@pytest.mark.parametrize("k", [1, 8, 50])
def test_top_k_puts_the_lower_index_first_among_ties(k):
    """Logits rounded to bf16 tie often; jax.lax.top_k keeps the lower
    index first, and so does the port's top-k."""
    rng = np.random.default_rng(k)
    logits = rng.normal(size=(64, 4096)).astype(np.float32)
    logits = np.array(jnp.asarray(logits * 4, jnp.bfloat16).astype(jnp.float32))
    logits[:, 100:120] = logits.max(axis=1, keepdims=True)  # 20 exact ties at the top
    want = np.asarray(jax.lax.top_k(jnp.asarray(logits), k)[1])
    got = tserve.top_k_ids(torch.from_numpy(logits), k).numpy()
    assert tserve.top_k_ids is tcommon.top_k_ids
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(n for n, a in treg.ARCHS.items() if a.family == "lm"))
def test_lm_configs_equal_the_jax_registrys(name):
    ja, ta = jreg.get_arch(name), treg.get_arch(name)
    assert (ta.name, ta.family, ta.notes) == (ja.name, ja.family, ja.notes)
    assert [dc.asdict(s) for s in ta.shapes] == [dc.asdict(s) for s in ja.shapes]
    for jc, tc in ((ja.config, ta.config), (ja.smoke_config, ta.smoke_config)):
        assert [f.name for f in dc.fields(tc)] == [f.name for f in dc.fields(jc)]
        for f in dc.fields(jc):
            a, b = getattr(jc, f.name), getattr(tc, f.name)
            if f.name == "dtype":
                assert DTYPES[a] == b
            elif f.name == "moe" and a is not None:
                assert dc.asdict(a) == dc.asdict(b)
            else:
                assert a == b, f.name
        assert tc.param_count() == jc.param_count()
        assert np.array_equal(tc.layer_is_local(), jc.layer_is_local())


def test_other_families_are_named_but_not_ported():
    """Every architecture of the JAX registry is in the port's, and each LM
    (the MoE ones since they were ported) and PNA has its config module."""
    from repro_torch.configs import (arctic_480b, gemma2_27b, gemma_2b, glm4_9b,
                                     llama4_scout_17b_a16e, pna)

    for mod, arch in ((gemma_2b, treg.GEMMA_2B), (gemma2_27b, treg.GEMMA2_27B),
                      (glm4_9b, treg.GLM4_9B), (llama4_scout_17b_a16e, treg.LLAMA4_SCOUT),
                      (arctic_480b, treg.ARCTIC_480B)):
        assert mod.ARCH is arch
        assert mod.CONFIG == arch.config and mod.SMOKE_CONFIG == arch.smoke_config
        assert set(mod.SHAPES) == {s.name for s in jreg.LM_SHAPES}
    assert pna.ARCH is treg.PNA and set(pna.SHAPES) == {s.name for s in jreg.PNA.shapes}
    assert set(treg.ARCHS) == set(jreg.ARCHS)
    with pytest.raises(KeyError):
        treg.get_arch("gpt-5")


def test_init_params_has_the_references_tree():
    """Seeded random weights from a torch.Generator: the reference's names,
    shapes and dtypes, a truncated normal of the reference's scales."""
    for name in ("gemma2ish", "qkv_bias"):
        jcfg = _tiny(**VARIANTS[name])
        want = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg))
        got = ttf.init_params(torch.Generator().manual_seed(0), port_config(jcfg)).tree()
        flat_w = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(want)[0]}
        flat_g = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(got)[0]}
        assert flat_w.keys() == flat_g.keys()
        for key, a in flat_w.items():
            assert tuple(flat_g[key].shape) == a.shape and flat_g[key].dtype == torch.float32, key
    cfg = port_config(_tiny(d_model=256, vocab_size=4096))
    params = ttf.init_params(torch.Generator().manual_seed(1), cfg)
    emb = params["embed"]
    assert float(emb.abs().max()) <= 2.0 and abs(float(emb.std()) - 0.8796) < 0.01
    q = params["layers"]["attn"]["q"]
    assert abs(float(q.std()) * 256**0.5 - 0.8796) < 0.02
    again = ttf.init_params(torch.Generator().manual_seed(1), cfg)
    assert torch.equal(again["embed"], emb)


def test_what_is_not_ported_raises():
    """Nothing of the model is refused as unported any more.  The mesh-bound
    paths, the shard-local MoE (``moe_batch_axes``) and the
    sequence-parallel residual (``act_seq_axis``), read the mesh handle and
    raise without one; on a mesh of one rank (a gloo world of one) they give
    the one-device values bit for bit (tests/test_torch_dist.py holds them
    to the reference on 4 ranks); an MoE config on one device runs
    (tests/test_torch_moe.py holds it to JAX)."""
    from repro_torch.launch.mesh import make_smoke_mesh

    jcfg = _tiny()
    _, tp, tcfg = _models(jcfg)
    tok = torch.zeros((1, 4), dtype=torch.int64)
    moe = dc.replace(tcfg, moe=ttf.MoEConfig(n_experts=4, top_k=1, d_ff=32))
    mp = ttf.init_params(torch.Generator().manual_seed(0), moe)
    logits, aux = ttf.forward(mp, tok, moe)
    assert logits.shape == (1, 4, moe.vocab_size) and float(aux) > 0
    sharded = dc.replace(moe, moe_batch_axes=("data",), moe_tp_axis="model")
    seq = dc.replace(tcfg, act_seq_axis="model")
    with pytest.raises(RuntimeError, match="set_moe_mesh"):
        ttf.forward(mp, tok, sharded)
    with pytest.raises(RuntimeError, match="set_moe_mesh"):
        ttf.forward(tp, tok, seq)
    with pytest.raises(RuntimeError, match="set_moe_mesh"):
        ttf.get_moe_mesh()
    mesh = make_smoke_mesh(device="cpu")
    try:
        ttf.set_mesh(mesh)
        assert ttf.get_moe_mesh() is mesh
        got, got_aux = ttf.forward(mp, tok, sharded)
        assert torch.equal(got, logits) and torch.equal(got_aux, aux)
        cache = ttf.init_cache(moe, 1, 6, device="cpu")
        want = ttf.decode_step(mp, {k: v.clone() for k, v in cache.items()}, tok[:, :1], moe)[0]
        assert torch.equal(ttf.decode_step(mp, cache, tok[:, :1], sharded)[0], want)
        assert torch.equal(ttf.forward(tp, tok, seq)[0], ttf.forward(tp, tok, tcfg)[0])
    finally:
        ttf.set_moe_mesh(None)
        torch.distributed.destroy_process_group()
    # the decode_window_slice lever is ported (tests/test_torch_window_slice.py):
    # on a model without local layers it changes nothing
    _, cache = ttf.prefill(tp, tok, tcfg, max_len=6)
    lever = ttf.decode_step(tp, {k: v.clone() for k, v in cache.items()}, tok[:, :1],
                            dc.replace(tcfg, decode_window_slice=True))[0]
    assert torch.equal(lever, ttf.decode_step(tp, cache, tok[:, :1], tcfg)[0])
    # training is ported (tests/test_torch_train.py), MoE's loss with its aux term
    assert float(ttf.loss_fn(mp, {"tokens": tok}, moe)) == pytest.approx(
        float(ttf.loss_fn(mp, {"tokens": tok}, dc.replace(
            moe, moe=dc.replace(moe.moe, router_aux_weight=0.0)))) + 0.01 * float(aux), rel=1e-6)
    tp["embed"].requires_grad_(True)
    assert torch.isfinite(ttf.loss_fn(tp, {"tokens": tok}, tcfg))
