"""The port's LM training path on the CPU against the JAX package's:
``SyntheticLM`` and ``ShardInfo``, ``loss_fn`` and its gradients against
``jax.value_and_grad(repro.models.transformer.loss_fn)``, a five-step
AdamW trajectory from the same weights and moments, the step builder's
kinds, the loss-decrease criterion of ``tests/test_train.py``, the
training CLI's kill and resume, and training checkpoints across packages.

Weights and moments are carried from JAX by ``params_from_numpy`` and
``opt_state_from_numpy``.  Tolerances:

* f32 loss: rtol 1e-5 (the forward's own, ``tests/test_torch_transformer.py``);
  f32 gradients: rtol 1e-4, atol 1e-6 of the leaf's largest entry (the
  backward sums over the batch and sequence in other orders);
* bf16 (gemma-2b's smoke config in bf16): loss within 2e-2 relative;
  gradients, which pass through many bf16 roundings, within 5e-2 of the
  leaf's largest entry, and their cosine with the reference's above 0.999;
* the trajectory (f32): parameters within rtol 1e-4, atol 1e-5 after five
  steps (an AdamW step normalises the gradient, so a gradient's relative
  difference moves a parameter by at most lr times it);
* checkpoints across packages: the resumed run's last parameters within
  1e-4 of the other package's uninterrupted run (the same steps, summed in
  other orders).

Remat against no remat and a resumed CLI run against an uninterrupted one
are bit-equal.
"""
import dataclasses as dc
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

import repro.train  # noqa: E402
import repro_torch.train  # noqa: E402

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
LOSS_F32_RTOL = 1e-5
GRAD_F32 = dict(rtol=1e-4, atol_rel=1e-6)
LOSS_BF16_RTOL = 2e-2
GRAD_BF16_ATOL_REL, GRAD_BF16_COS = 5e-2, 0.999
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
CKPT_ATOL = 1e-4


def port_config(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)}
    kw["dtype"] = DTYPES[jcfg.dtype]
    return ttf.TransformerConfig(**kw)


def _tiny(**over):
    base = dict(n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                vocab_size=128, dtype=jnp.float32, q_chunk=None, remat=False)
    base.update(over)
    return jtf.TransformerConfig(**base)


GEMMA_SMOKE = jreg.get_arch("gemma-2b").smoke_config
CASES = {
    "gemma-2b-smoke": GEMMA_SMOKE,
    "gemma-2b-smoke-remat": dc.replace(GEMMA_SMOKE, remat=True),
    "gemma2ish-chunked-remat": _tiny(
        attn_pattern="local_global", window=6, q_chunk=8, attn_logit_softcap=50.0,
        final_logit_softcap=30.0, post_norms=True, embed_scale=True, tie_embeddings=True,
        activation="gelu", query_scale=0.3, remat=True),
    "qkv_bias": _tiny(qkv_bias=True),
    "gemma-2b-smoke-bf16": dc.replace(GEMMA_SMOKE, dtype=jnp.bfloat16, remat=True),
}


def _models(jcfg, seed=0):
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp, port_config(jcfg)


def _tokens(seed, vocab, shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_train_exports_every_name_of_the_references():
    assert set(repro.train.__all__) <= set(repro_torch.train.__all__)
    for name in repro.train.__all__:
        assert getattr(repro_torch.train, name) is not None


@pytest.mark.parametrize("seed,step,index,count", [(0, 0, 0, 1), (0, 7, 0, 2), (0, 7, 1, 2),
                                                   (3, 12, 2, 4), (11, 1, 0, 1)])
def test_synthetic_lm_batches_equal_the_references(seed, step, index, count):
    args = (100, 16, 8)
    want = jdata.SyntheticLM(*args, seed=seed, shard=jdata.ShardInfo(index, count)).batch(step)
    got = tdata.SyntheticLM(*args, seed=seed, shard=tdata.ShardInfo(index, count)).batch(step)
    assert got["tokens"].dtype == np.int32 and got["tokens"].shape == (8 // count, 16)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    first = next(iter(tdata.SyntheticLM(*args, seed=seed)))
    np.testing.assert_array_equal(first["tokens"], jdata.SyntheticLM(*args, seed=seed).batch(0)["tokens"])
    with pytest.raises(ValueError):
        tdata.SyntheticLM(100, 16, 7, shard=tdata.ShardInfo(0, 2))


def test_shard_info_from_runtime_reads_the_process_group(tmp_path):
    assert tdata.ShardInfo.from_runtime() == tdata.ShardInfo(0, 1)
    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", rank=0,
                            world_size=1)
    try:
        assert tdata.ShardInfo.from_runtime() == tdata.ShardInfo(0, 1)
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def _loss_and_grads(name, seed=0):
    jcfg = CASES[name]
    jp, tp, tcfg = _models(jcfg, seed)
    tok = _tokens(seed + 1, jcfg.vocab_size, (2, 20))
    jl, jg = jax.jit(jax.value_and_grad(jtf.loss_fn), static_argnums=2)(
        jp, {"tokens": jnp.asarray(tok)}, jcfg)
    tl, tg = tsteps.value_and_grad(ttf.loss_fn)(tp, {"tokens": torch.from_numpy(tok)}, tcfg)
    return jl, jg, tl, tg


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_equal_jax(name):
    jl, jg, tl, tg = _loss_and_grads(name)
    assert tl.dtype == torch.float32 and tl.dim() == 0 and not tl.requires_grad
    fj, ft = _flat(jg), _flat(tg)
    assert fj.keys() == ft.keys()
    bf16 = CASES[name].dtype == jnp.bfloat16
    if bf16:
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_BF16_RTOL)
    else:
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_F32_RTOL)
    for key, want in fj.items():
        got, want = ft[key], _np(want)
        assert got.dtype == DTYPES[CASES[name].dtype] and tuple(got.shape) == want.shape, key
        got, scale = _np(got), np.abs(want).max()
        if bf16:
            assert np.abs(got - want).max() <= GRAD_BF16_ATOL_REL * scale, key
            cos = (got * want).sum() / np.sqrt((got**2).sum() * (want**2).sum())
            assert cos > GRAD_BF16_COS, key
        else:
            np.testing.assert_allclose(got, want, rtol=GRAD_F32["rtol"],
                                       atol=GRAD_F32["atol_rel"] * scale, err_msg=key)


def test_remat_gradients_equal_plain_ones_bit_for_bit():
    jcfg = CASES["gemma2ish-chunked-remat"]
    _, tp, tcfg = _models(jcfg)
    batch = {"tokens": torch.from_numpy(_tokens(5, jcfg.vocab_size, (2, 20)))}
    vg = tsteps.value_and_grad(ttf.loss_fn)
    l1, g1 = vg(tp, batch, tcfg)
    l0, g0 = vg(tp, batch, dc.replace(tcfg, remat=False))
    assert torch.equal(l0, l1)
    for a, b in zip(tcommon.tree_leaves(g0), tcommon.tree_leaves(g1)):
        assert torch.equal(a, b)
    # the stacked parameters get their layers' gradients stacked
    assert g1["layers"]["attn"]["q"].shape == (jcfg.n_layers, 32, 32)
    assert bool((g1["layers"]["attn"]["q"].abs().sum(dim=(1, 2)) > 0).all())
    # serving is unchanged: no graph without gradients
    with torch.no_grad():
        assert not ttf.forward(tp, batch["tokens"], tcfg)[0].requires_grad


def _jax_step(cfg, opt_cfg, update):
    @jax.jit
    def step(params, state, batch):
        loss, grads = jax.value_and_grad(jtf.loss_fn)(params, batch, cfg)
        params, state = update(params, grads, state, opt_cfg)
        return params, state, loss

    return step


def test_five_step_trajectory_from_the_jax_weights_and_moments():
    """Two JAX steps give non-zero moments; both packages then take five
    more from those weights and moments on the same batches."""
    jcfg = CASES["gemma-2b-smoke"]
    jp, _, tcfg = _models(jcfg)
    cfg = dict(lr=3e-3, warmup_steps=5)
    jstep = _jax_step(jcfg, joptim.AdamWConfig(**cfg), joptim.apply_updates)
    data = jdata.SyntheticLM(jcfg.vocab_size, 32, 4, seed=1)
    js = joptim.init_opt_state(jp)
    for i in range(2):
        jp, js, _ = jstep(jp, js, {"tokens": jnp.asarray(data.batch(i)["tokens"])})
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ts = toptim.opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    tstep = tsteps._train_step(ttf.loss_fn, tcfg, toptim.apply_updates, toptim.AdamWConfig(**cfg))
    for i in range(2, 7):
        tok = data.batch(i)["tokens"]
        jp, js, jl = jstep(jp, js, {"tokens": jnp.asarray(tok)})
        tp, ts, out = tstep(tp, ts, {"tokens": torch.from_numpy(tok)})
        np.testing.assert_allclose(float(out["loss"]), float(jl), rtol=LOSS_F32_RTOL)
    assert int(ts.step) == int(js.step) == 7
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        fw, fg = _flat(want), _flat(tcommon.tree_map(lambda t: t, got))
        assert fw.keys() == fg.keys()
        for key, w in fw.items():
            scale = np.abs(_np(w)).max()
            np.testing.assert_allclose(_np(fg[key]), _np(w), rtol=TRAJ_TOL["rtol"],
                                       atol=TRAJ_TOL["atol"] * max(scale, 1e-30), err_msg=key)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_loss_decreases(optimizer):
    """``tests/test_train.py::test_loss_decreases`` on the port."""
    cfg = ttf.TransformerConfig(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
        vocab_size=64, dtype=torch.float32, q_chunk=None, remat=False,
    )
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    data = tdata.SyntheticLM(vocab_size=64, seq_len=32, global_batch=8, seed=1)
    if optimizer == "adamw":
        state = toptim.init_opt_state(params)
        step = tsteps._train_step(ttf.loss_fn, cfg, toptim.apply_updates,
                                  toptim.AdamWConfig(lr=3e-3, warmup_steps=5))
    else:
        state = toptim.init_adafactor_state(params)
        step = tsteps._train_step(ttf.loss_fn, cfg, toptim.adafactor_updates,
                                  toptim.AdafactorConfig(lr=3e-2, warmup_steps=5))
    losses = []
    for _, batch in zip(range(30), data):
        params, state, out = step(params, state, {"tokens": torch.from_numpy(batch["tokens"])})
        losses.append(float(out["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_build_lm_step_kinds_at_the_smoke_config():
    arch = treg.get_arch("gemma-2b")
    jarch = jreg.get_arch("gemma-2b")
    train = tsteps.build_lm_step(arch, arch.shape("train_4k"), smoke=True)
    assert (train.batch, train.seq_len, train.optimizer) == (4, 64, "adamw")
    cfg = train.cfg
    assert train.model_flops == 6.0 * cfg.active_param_count() * 4 * 64
    assert cfg.active_param_count() == cfg.param_count() == jarch.smoke_config.active_param_count()
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    state = train.init_opt_state(params)
    tok = torch.from_numpy(_tokens(7, cfg.vocab_size, (train.batch, train.seq_len)))
    with torch.no_grad():
        want = tcommon.cross_entropy(ttf.forward(params, tok, cfg)[0][:, :-1], tok[:, 1:])
    params, state, out = train.fn(params, state, {"tokens": tok})
    assert torch.equal(out["loss"], want) and int(state.step) == 1

    pre = tsteps.build_lm_step(arch, arch.shape("prefill_32k"), smoke=True)
    assert pre.model_flops == 2.0 * cfg.active_param_count() * 4 * 64
    with torch.no_grad():
        logits, cache = pre.fn(params, tok)
        dec = tsteps.build_lm_step(arch, arch.shape("decode_32k"), smoke=True)
        assert dec.model_flops == 2.0 * cfg.active_param_count() * 4
        step_logits, cache = dec.fn(params, cache, tok[:, :1])
    assert logits.shape == step_logits.shape == (4, cfg.vocab_size) and int(cache["len"]) == 65
    big = tsteps.build_lm_step(treg.get_arch("llama4-scout-17b-a16e"), LM_TRAIN, smoke=True)
    assert big.optimizer == "adafactor"
    assert isinstance(big.init_opt_state(params), toptim.FactoredState)
    with pytest.raises(ValueError):
        tsteps.build_lm_step(treg.get_arch("sasrec"), LM_TRAIN)


LM_TRAIN = treg.get_arch("gemma-2b").shape("train_4k")


def test_optimizer_checkpoint_keys_equal_the_references(tmp_path):
    """A NamedTuple's fields are keyed ``.step``, ``.mu``, ``.nu`` as JAX's
    ``GetAttrKey``s, in field order."""
    tree = {"w": np.ones((2, 3), np.float32), "b": [np.zeros(4, np.float32)]}
    jstate = joptim.init_opt_state(jax.tree.map(jnp.asarray, tree))
    tstate = toptim.init_opt_state(tcommon.tree_map(torch.from_numpy, tree))
    fstate = toptim.init_adafactor_state(tcommon.tree_map(torch.from_numpy, tree))
    jf = joptim.init_adafactor_state(jax.tree.map(jnp.asarray, tree))
    for jst, tst in ((jstate, tstate), (jf, fstate)):
        want = [k for k, _ in jck._flatten_with_paths({"opt": jst})]
        assert [k for k, _ in tck._flatten_with_paths({"opt": tst})] == want
    tck.save(str(tmp_path), 3, {"opt": tstate})
    back, step = tck.restore(str(tmp_path), {"opt": tstate})
    assert step == 3 and type(back["opt"]) is toptim.OptState
    jback, _ = jck.restore(str(tmp_path), {"opt": jstate})
    assert type(jback["opt"]) is joptim.OptState


CLI = ["--arch", "gemma-2b", "--steps", "60", "--seq-len", "32", "--batch", "4",
       "--ckpt-every", "20"]


def _arrays(ckpt_dir, step):
    with np.load(os.path.join(ckpt_dir, f"step_{step:010d}", "arrays.npz")) as a:
        return {k: a[k] for k in a.files}


def test_cli_kill_and_resume_matches_uninterrupted(tmp_path, capsys):
    """``tests/test_fault_tolerance.py``'s run on the port's CLI, in
    process on the CPU: bit-equal."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    assert ttrain.main(CLI + ["--ckpt-dir", d1, "--device", "cpu"]) == 0
    with pytest.raises(SystemExit) as kill:
        ttrain.main(CLI + ["--ckpt-dir", d2, "--kill-at", "30", "--device", "cpu"])
    assert kill.value.code == 42 and tck.latest_step(d2) == 20
    assert ttrain.main(CLI + ["--ckpt-dir", d2, "--resume", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 20" in out and "simulating node failure at step 30" in out
    assert "step    59 loss" in out and out.rstrip().endswith("done")
    a, b = _arrays(d1, 59), _arrays(d2, 59)
    assert sorted(a) == sorted(b) and "opt/.step" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cli_resumes_the_other_packages_checkpoint(tmp_path, capsys, writer):
    """One package's CLI writes checkpoints through step 20 and is killed
    at 25; the other's resumes from 20 and runs to 40, ending where the
    first package's uninterrupted run ends."""
    common = ["--arch", "gemma-2b", "--steps", "40", "--seq-len", "16", "--batch", "2",
              "--ckpt-every", "10"]
    first, second = ((jtrain.main, []), (ttrain.main, ["--device", "cpu"]))
    if writer == "port":
        first, second = second, first
    full, split = str(tmp_path / "full"), str(tmp_path / "split")
    assert first[0](common + ["--ckpt-dir", full] + first[1]) == 0
    with pytest.raises(SystemExit):
        first[0](common + ["--ckpt-dir", split, "--kill-at", "25"] + first[1])
    assert second[0](common + ["--ckpt-dir", split, "--resume"] + second[1]) == 0
    assert "resumed from step 20" in capsys.readouterr().out
    a, b = _arrays(full, 39), _arrays(split, 39)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=CKPT_ATOL, err_msg=k)
