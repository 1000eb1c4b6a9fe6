"""The port's MoE layer on the CPU against the JAX package's.

``_moe_local`` under both expert implementations against the reference's
``_moe_local(..., tp_axis=None)`` on seeded numpy inputs that reach the
capacity path's corners (a group longer than its window, a window clamped
at the end of the slots, an expert with no slots, fewer than 8 slots,
all-zero token rows whose probabilities tie); ``_capacity_grouped_ffn``
slot for slot; ``forward``, ``prefill`` with three decode steps and
``loss_fn`` with its gradients for llama4-scout's and arctic's smoke
configs, JAX weights carried across by ``params_from_numpy``;
``build_lm_step(smoke=True)`` against the reference's bundle on
``make_smoke_mesh()`` run eagerly (one shard, so the reference's
shard-local MoE is its ``_moe_local`` over every token); ``init_params``'s
tree.

Tolerances.  Expert choices and capacity drops are integers and equal
exactly.  The f32 values are not bit-equal: XLA's and torch's f32 dot
products and ``exp`` differ by an ulp on the CPU, so the router's
probabilities do too, and so the aux (a mean of them) is held to rtol 1e-6,
a few f32 roundings; f32 outputs to rtol 1e-5, atol 1e-6 (measured: within
5e-7 of outputs of ~1).  In bf16 every FFN intermediate is rounded to 8
significant bits, by the two packages in other orders: outputs within
2**-6 of the largest output, and the mean difference below 2**-9 of it.
Model-level tolerances are ``tests/test_torch_transformer.py``'s and
``tests/test_torch_train.py``'s.
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
from repro.models import transformer as jtf  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
F32_TOL = dict(rtol=1e-5, atol=1e-6)
AUX_RTOL = 1e-6
BF16_REL, BF16_MEAN_REL = 2.0**-6, 2.0**-9
LOGIT_TOL = dict(rtol=1e-5, atol=2e-5)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6
#: top-1's renormalised weight is p / p = 1, so the router's gradient
#: through it is a cancellation, rounding noise of ~1e-5 of the leaf's
#: largest entry beside the aux term's gradient (measured 1.07e-5)
ROUTER_TOP1_ATOL_REL = 5e-5
PARAM_ATOL = 1e-5
ARCHS = ("llama4-scout-17b-a16e", "arctic-480b")


def port_config(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)}
    kw["dtype"] = DTYPES[jcfg.dtype]
    if jcfg.moe is not None:
        kw["moe"] = ttf.MoEConfig(**dc.asdict(jcfg.moe))
    return ttf.TransformerConfig(**kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cfg(n_experts, top_k, residual=0, impl="capacity", cf=1.0, dtype=jnp.float32):
    return jtf.TransformerConfig(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128,
        dtype=dtype, q_chunk=None, remat=False,
        moe=jtf.MoEConfig(n_experts=n_experts, top_k=top_k, d_ff=32,
                          dense_residual_ff=residual, impl=impl, capacity_factor=cf))


def _inputs(seed, t, n_experts, dtype="f32"):
    """x (T, 32), router (32, E) f32, wi, wo.  Feature 0 of every token is 3
    and the router's row 0 favours expert 0 and shuns the last expert, so
    expert 0's group outgrows a window at capacity factor 1, the last
    expert gets no slot and the last non-empty group's window is clamped;
    tokens 1 and 4 are all zeros (every expert equally likely)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, 32)).astype(np.float32)
    x[:, 0] = 3.0
    x[[1, 4] if t > 4 else [1]] = 0.0
    router = (rng.normal(size=(32, n_experts)) * 0.3).astype(np.float32)
    router[0] = 0.0
    router[0, 0], router[0, -1] = 0.5, -3.0
    wi = (rng.normal(size=(n_experts, 32, 2, 32)) * 0.25).astype(np.float32)
    wo = (rng.normal(size=(n_experts, 32, 32)) * 0.25).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jx, jwi, jwo = (jnp.asarray(a).astype(jdt) for a in (x, wi, wo))
    arrays = (jx, jnp.asarray(router), jwi, jwo)
    return arrays, tuple(tcommon.tensor_from_numpy(a, "cpu") for a in arrays)


def _reference_routing(x, router, cfg):
    """The reference's routing expressions (``_moe_local``'s first lines)."""
    probs = jax.nn.softmax(x.astype(jnp.float32) @ router.astype(jnp.float32), axis=-1)
    weights, experts = jax.lax.top_k(probs, cfg.moe.top_k)
    return np.asarray(experts), np.asarray(weights / jnp.maximum(weights.sum(-1, keepdims=True),
                                                                  1e-9))


def _layout(experts, n_experts, cfg):
    """Group sizes, window starts and the capacity of the reference's
    formula, from the expert choices (numpy)."""
    flat = experts.reshape(-1)
    sizes = np.bincount(flat, minlength=n_experts)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    tk = len(flat)
    cap = min(max(int(np.ceil(cfg.moe.capacity_factor * tk / n_experts / 8)) * 8, 8), tk)
    return sizes, starts, cap, tk


def _close_bf16(got, want):
    got, want = _np(got), _np(want)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= BF16_REL * scale
    assert np.abs(got - want).mean() <= BF16_MEAN_REL * scale


#: (E, k, dense residual width, tokens): top-1 with and without the
#: residual, top-2 with and without, and top-2 over 3 tokens (6 slots < 8)
LOCAL_CASES = {
    "top1_residual": (4, 1, 32, 24),
    "top1": (4, 1, 0, 24),
    "top2": (8, 2, 0, 24),
    "top2_residual": (4, 2, 32, 20),
    "top2_six_slots": (4, 2, 0, 3),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["capacity", "ragged"])
@pytest.mark.parametrize("case", sorted(LOCAL_CASES))
def test_moe_local_equals_jax(case, impl, dtype):
    e, k, residual, t = LOCAL_CASES[case]
    jcfg = _cfg(e, k, residual, impl, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tcfg = port_config(jcfg)
    (jx, jr, jwi, jwo), (tx, tr, twi, two) = _inputs(sorted(LOCAL_CASES).index(case), t, e, dtype)
    want, aux_w = jtf._moe_local(jx, jr, jwi, jwo, jcfg, None)
    got, aux_g = ttf._moe_local(tx, tr, twi, two, tcfg)
    assert got.dtype == DTYPES[jcfg.dtype] and got.shape == want.shape
    np.testing.assert_allclose(float(aux_g), float(aux_w), rtol=AUX_RTOL)
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    else:
        _close_bf16(got, want)
    # the routing and the corners the inputs were built to reach
    experts, weights = _reference_routing(jx, jr, jcfg)
    _, w_port, e_port = ttf._route(tx, tr, tcfg)
    assert np.array_equal(e_port.numpy(), experts)
    np.testing.assert_allclose(w_port.numpy(), weights, rtol=1e-6, atol=1e-7)
    assert list(experts[1]) == list(range(k))  # an all-zero row: the lower experts first
    sizes, starts, cap, tk = _layout(experts, e, jcfg)
    assert sizes[-1] == 0, "an expert with no slot"
    if t > 4:
        assert sizes[0] > cap, "a group longer than its window"
        last = np.nonzero(sizes)[0][-1]
        assert starts[last] > tk - cap, "the last group's window is clamped"
    else:
        assert tk < 8 and cap == tk


@pytest.mark.parametrize("case", sorted(LOCAL_CASES))
def test_capacity_drops_slot_for_slot(case):
    """``_capacity_grouped_ffn`` on the same sorted slots and group sizes:
    the slots each package drops (its rows of zeros) are the same ones, and
    the kept rows agree; the drops are the reference's formula's."""
    e, k, residual, t = LOCAL_CASES[case]
    jcfg = _cfg(e, k, residual)
    (jx, jr, jwi, jwo), (tx, _, twi, two) = _inputs(sorted(LOCAL_CASES).index(case), t, e)
    experts, _ = _reference_routing(jx, jr, jcfg)
    sizes, starts, cap, tk = _layout(experts, e, jcfg)
    order = np.argsort(experts.reshape(-1), kind="stable")
    xs = np.asarray(jx)[order // k]
    xs[(xs == 0).all(-1)] = 1.0  # a zero row's FFN is zero: no row of xs is, so a zero is a drop
    want = np.asarray(jtf._capacity_grouped_ffn(jnp.asarray(xs), jwi, jwo,
                                                jnp.asarray(sizes, jnp.int32), jcfg))
    got = ttf._capacity_grouped_ffn(torch.from_numpy(xs), twi, two, torch.from_numpy(sizes),
                                    port_config(jcfg)).numpy()
    kept_w, kept_g = np.abs(want).max(-1) > 0, np.abs(got).max(-1) > 0
    assert np.array_equal(kept_g, kept_w)
    windows = np.minimum(starts, tk - cap)
    expect = np.concatenate([np.arange(n) < windows[i] + cap - starts[i]
                             for i, n in enumerate(sizes)])
    assert np.array_equal(kept_g, expect)
    if t > 4:
        assert (~kept_g[: sizes[0]]).sum() == sizes[0] - cap > 0
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_capacity_equals_ragged_when_roomy():
    """``tests/test_models.py``'s check on the port: at capacity factor 8
    nothing drops, and the two implementations agree."""
    jcfg = _cfg(4, 2, cf=8.0)
    (_, _, _, _), (tx, tr, twi, two) = _inputs(5, 24, 4)
    cap, _ = ttf._moe_local(tx, tr, twi, two, port_config(jcfg))
    rag, _ = ttf._moe_local(tx, tr, twi, two, port_config(dc.replace(
        jcfg, moe=dc.replace(jcfg.moe, impl="ragged"))))
    np.testing.assert_allclose(cap.numpy(), rag.numpy(), rtol=1e-5, atol=1e-6)


def _models(name, **over):
    jcfg = dc.replace(jreg.get_arch(name).smoke_config, **over)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tp, port_config(jcfg)


def _tokens(seed, vocab, shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_smoke_forward_prefill_and_decode_equal_jax(name):
    """At the smoke config (f32, capacity factor 1.25: drops happen) the
    forward's logits and aux, prefill's logits and cache and three decode
    steps' equal the reference's."""
    jcfg, jp, tp, tcfg = _models(name)
    tok = _tokens(1, jcfg.vocab_size, (2, 20))
    want, aux_w = jtf.forward(jp, jnp.asarray(tok), jcfg)
    got, aux_g = ttf.forward(tp, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux_g), float(aux_w), rtol=AUX_RTOL)
    assert float(aux_g) > 0
    lj, cj = jtf.prefill(jp, jnp.asarray(tok), jcfg, max_len=24)
    lt, ct = ttf.prefill(tp, torch.from_numpy(tok), tcfg, max_len=24)
    np.testing.assert_allclose(_np(lt), _np(lj), **LOGIT_TOL)
    for step in range(3):
        nxt = _tokens(10 + step, jcfg.vocab_size, (2, 1))
        lj, cj = jtf.decode_step(jp, cj, jnp.asarray(nxt), jcfg)
        lt, ct = ttf.decode_step(tp, ct, torch.from_numpy(nxt), tcfg)
        np.testing.assert_allclose(_np(lt), _np(lj), **LOGIT_TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(ct[key]), _np(cj[key]), rtol=1e-5, atol=1e-5)
    assert int(ct["len"]) == int(cj["len"]) == 23


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_smoke_loss_and_gradients_equal_jax(name, remat):
    """``loss_fn`` (with its router aux term) and the gradients of every
    parameter, the router, the experts and the dense residual included."""
    jcfg, jp, tp, tcfg = _models(name, remat=remat)
    tok = _tokens(2, jcfg.vocab_size, (2, 16))
    lw, gw = jax.value_and_grad(jtf.loss_fn)(jp, {"tokens": jnp.asarray(tok)}, jcfg)
    lg, gg = tsteps.value_and_grad(ttf.loss_fn)(tp, {"tokens": torch.from_numpy(tok)}, tcfg)
    np.testing.assert_allclose(float(lg), float(lw), rtol=LOSS_RTOL)
    fw, fg = _flat(gw), _flat(tcommon.tree_map(lambda t: t, gg))
    assert fw.keys() == fg.keys()
    assert {"['layers']['moe']['router']", "['layers']['moe']['wi']",
            "['layers']['moe']['wo']", "['layers']['mlp']['wi']"} <= fw.keys()
    for key, w in fw.items():
        w = _np(w)
        assert np.abs(w).max() > 0, key
        atol = (ROUTER_TOP1_ATOL_REL if key.endswith("['router']") and jcfg.moe.top_k == 1
                else GRAD_ATOL_REL)
        np.testing.assert_allclose(_np(fg[key]), w, rtol=GRAD_RTOL,
                                   atol=atol * np.abs(w).max(), err_msg=key)


def test_smoke_remat_gradients_equal_plain_ones_bit_for_bit():
    _, _, tp, tcfg = _models("arctic-480b")
    tok = torch.from_numpy(_tokens(3, tcfg.vocab_size, (2, 16)))
    vg = tsteps.value_and_grad(ttf.loss_fn)
    l1, g1 = vg(tp, {"tokens": tok}, dc.replace(tcfg, remat=True))
    l0, g0 = vg(tp, {"tokens": tok}, tcfg)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(tcommon.tree_leaves(g1),
                                                 tcommon.tree_leaves(g0)))


def _bundle(name, shape):
    arch = jreg.get_arch(name)
    with make_smoke_mesh() as mesh:
        return jsteps.build_lm_step(arch, arch.shape(shape), mesh, smoke=True)


@pytest.mark.parametrize("name", ARCHS)
def test_build_lm_step_equals_the_references_bundle(name):
    """train (Adafactor), prefill and decode at the smoke config: one train
    step's loss and updated parameters, then prefill's logits and a decode
    step's, against the reference's bundles run eagerly on
    ``make_smoke_mesh()`` from the same weights."""
    jcfg, jp, tp, _ = _models(name)
    tarch = treg.get_arch(name)
    train = tsteps.build_lm_step(tarch, tarch.shape("train_4k"), smoke=True)
    bundle = _bundle(name, "train_4k")
    assert train.optimizer == "adafactor" and train.model_flops == bundle.model_flops
    assert bundle.inputs[2]["tokens"].shape == (train.batch, train.seq_len)
    tok = _tokens(4, jcfg.vocab_size, (train.batch, train.seq_len))
    with make_smoke_mesh():
        jp2, _, jout = bundle.fn(jp, joptim.init_adafactor_state(jp), {"tokens": jnp.asarray(tok)})
    state = train.init_opt_state(tp)
    tp2, state, tout = train.fn(tp, state, {"tokens": torch.from_numpy(tok)})
    assert int(state.step) == 1
    np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), rtol=LOSS_RTOL)
    fw, fg = _flat(jp2), _flat(tcommon.tree_map(lambda t: t, tp2))
    assert fw.keys() == fg.keys()
    for key, w in fw.items():
        np.testing.assert_allclose(_np(fg[key]), _np(w), rtol=GRAD_RTOL, atol=PARAM_ATOL,
                                   err_msg=key)

    jp = jp2  # the prefill and decode steps on the trained weights
    pre = tsteps.build_lm_step(tarch, tarch.shape("prefill_32k"), smoke=True)
    jpre = _bundle(name, "prefill_32k")
    assert pre.model_flops == jpre.model_flops
    with make_smoke_mesh():
        lj, cj = jpre.fn(jp, jnp.asarray(tok))
    with torch.no_grad():
        lt, ct = pre.fn(tp2, torch.from_numpy(tok))
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-4, atol=1e-4)
    dec = tsteps.build_lm_step(tarch, tarch.shape("decode_32k"), smoke=True)
    jdec = _bundle(name, "decode_32k")
    assert dec.model_flops == jdec.model_flops
    # one free slot past the prompt, so the step writes no clamped slot
    for key in ("k", "v"):
        cj[key] = jnp.pad(cj[key], ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
        ct[key] = torch.nn.functional.pad(ct[key], (0, 0, 0, 0, 0, 1))
    nxt = _tokens(5, jcfg.vocab_size, (train.batch, 1))
    with make_smoke_mesh():
        lj, _ = jdec.fn(jp, cj, jnp.asarray(nxt))
    with torch.no_grad():
        lt, ct = dec.fn(tp2, ct, torch.from_numpy(nxt))
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-4, atol=1e-4)
    assert int(ct["len"]) == train.seq_len + 1


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_has_the_references_tree(name):
    """Seeded random weights from a torch.Generator with the reference's
    names, shapes and dtypes: the router in f32 (the model's dtype is f32
    at the smoke config, so also in bf16), the experts drawn one at a time
    at the reference's scales, ``mlp`` only with a dense residual."""
    jcfg = jreg.get_arch(name).smoke_config
    for dtype in (jnp.float32, jnp.bfloat16):
        cfg = dc.replace(jcfg, dtype=dtype)
        want = _flat(jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), cfg)))
        got = _flat(ttf.init_params(torch.Generator().manual_seed(0), port_config(cfg)).tree())
        assert want.keys() == got.keys()
        for key, a in want.items():
            assert tuple(got[key].shape) == a.shape, key
            assert got[key].dtype == DTYPES[jnp.float32 if a.dtype == np.float32 else
                                            jnp.bfloat16], key
    assert got["['layers']['moe']['router']"].dtype == torch.float32
    no_residual = dc.replace(jcfg, moe=dc.replace(jcfg.moe, dense_residual_ff=0))
    tree = ttf.init_params(torch.Generator().manual_seed(0), port_config(no_residual)).tree()
    assert "mlp" not in tree["layers"]
    # the experts' scales: d**-0.5 for wi, d_ff**-0.5 for wo, a truncated normal
    big = port_config(dc.replace(jcfg, d_model=256, moe=dc.replace(jcfg.moe, d_ff=256)))
    moe = ttf.init_params(torch.Generator().manual_seed(1), big)["layers"]["moe"]
    for leaf in (moe["wi"], moe["wo"]):
        for e in range(big.moe.n_experts):
            assert abs(float(leaf[0, e].std()) * 256**0.5 - 0.8796) < 0.02
            assert float(leaf[0, e].abs().max()) <= 2.0 / 256**0.5 + 1e-6
        assert not torch.equal(leaf[0, 0], leaf[0, 1])
