"""The ``decode_window_slice`` lever on the CPU against the JAX package's.

A local layer in decode attends only over its window slice: the ``w =
min(window, S)`` keys from ``start = clip(cur_len - (w - 1), 0, S - w)``,
masked by ``pos <= cur_len`` (``repro.models.transformer.layer_forward``).
The port's plain ``decode_attention`` has the mode (the kernel's yardstick;
the kernel itself is held to it on the card in
``tests/test_torch_cuda_kernels.py``).

* ``decode_step`` with the lever on, against the reference's with the
  lever on (``scan_layers=False``), for the two cases of
  ``tests/test_perf_levers.py`` and fill levels past the window, at the
  cache's last slot and past it; and against the port's own full read
  where the two read the same keys (every fill level inside the cache).
  f32 logits: rtol 1e-5, atol 2e-5 (``tests/test_torch_transformer.py``'s);
  three chained steps;
* the plain version's window-slice mode against the JAX package's
  decode-attention oracle on the slice it reads, and against its own full
  read with the window: 2e-6 in f32 (``tests/test_kernels.py``'s).
"""
import dataclasses as dc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_op  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_plain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=2e-5)
OP_TOL = dict(rtol=2e-6, atol=2e-6)


def _cfg(**over):
    base = dict(n_layers=4, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                vocab_size=128, dtype=jnp.float32, q_chunk=None, remat=False,
                attn_pattern="local_global", window=8)
    base.update(over)
    return jtf.TransformerConfig(**base)


def _port(jcfg, **over):
    kw = {f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)}
    kw.update(dtype=torch.float32, **over)
    return ttf.TransformerConfig(**kw)


def _cache_np(cache):
    return {k: np.array(v) for k, v in cache.items()}


def _port_cache(cache):
    return {"k": torch.from_numpy(cache["k"].copy()), "v": torch.from_numpy(cache["v"].copy()),
            "len": torch.tensor(int(cache["len"]), dtype=torch.int32)}


#: (config overrides, batch, prompt length, cache slots): the two cases of
#: tests/test_perf_levers.py (window 8, 20 of 32 filled; window 16, 4 of
#: 64), a fill past the window, the last slot, and a full cache (the next
#: token is written over the last slot, as the reference's clamped
#: dynamic_update_slice writes it)
CASES = {
    "perf_levers_full_read": (dict(), 2, 20, 32),
    "perf_levers_early": (dict(n_layers=2, window=16), 1, 4, 64),
    "past_the_window": (dict(n_layers=2, window=16, n_kv_heads=1), 2, 30, 64),
    "the_last_slot": (dict(window=8), 2, 31, 32),
    "a_full_cache": (dict(n_layers=2, window=8), 1, 32, 32),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_with_the_lever_equals_the_references(name):
    over, b, prompt, slots = CASES[name]
    jcfg = _cfg(**over)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = jax.random.randint(jax.random.PRNGKey(1), (b, prompt), 0, jcfg.vocab_size)
    _, cache = jtf.prefill(jp, tokens, jcfg, max_len=slots)
    cache = _cache_np(cache)
    jlever = dc.replace(jcfg, decode_window_slice=True, scan_layers=False)
    tlever, tfull = _port(jcfg, decode_window_slice=True), _port(jcfg)
    nxt = np.random.default_rng(prompt).integers(0, jcfg.vocab_size, (3, b, 1)).astype(np.int32)
    jc, tc_lever, tc_full = dict(cache), _port_cache(cache), _port_cache(cache)
    for t in range(3):
        want, jc = jtf.decode_step(jp, jc, jnp.asarray(nxt[t]), jlever)
        got, tc_lever = ttf.decode_step(tp, tc_lever, torch.from_numpy(nxt[t]), tlever)
        full, tc_full = ttf.decode_step(tp, tc_full, torch.from_numpy(nxt[t]), tfull)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        if prompt + t < slots:  # inside the cache both read the window's keys
            np.testing.assert_allclose(got.numpy(), full.numpy(), **F32_TOL)
        np.testing.assert_allclose(tc_lever["k"].numpy(), np.asarray(jc["k"]), rtol=1e-5,
                                   atol=1e-5)
        assert int(tc_lever["len"]) == int(jc["len"]) == prompt + t + 1


def _qkv(seed, b, hkv, g, d, s):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d))]


@pytest.mark.parametrize("b,hkv,g,d,s,w,cap", [
    (2, 2, 4, 16, 64, 16, None), (1, 16, 2, 32, 100, 40, 50.0), (3, 2, 8, 16, 50, 64, None),
    (2, 1, 3, 8, 33, 1, 30.0),
])
def test_plain_window_slice_equals_the_oracle_on_its_slice(b, hkv, g, d, s, w, cap):
    """The slice's keys through the JAX oracle, ``cur`` relative to the
    slice's start; and, inside the cache, the plain full read with the
    window, which keeps the same keys."""
    q, k, v = _qkv(s + w, b, hkv, g, d, s)
    for cur in sorted({0, 1, w - 1, w, s // 2, s - 1, s, s + 3}):
        ww = min(w, s)
        start = min(max(cur - (ww - 1), 0), s - ww)
        want = decode_attention_ref(jnp.asarray(q), jnp.asarray(k[:, start:start + ww]),
                                    jnp.asarray(v[:, start:start + ww]), cur - start,
                                    d**-0.5, cap, None)
        cur_t = torch.tensor(cur, dtype=torch.int32)
        args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cur_t, d**-0.5, cap)
        got = decode_attention_plain(*args, window_slice=w)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
        # the op and the wrapper run the plain version on the CPU
        before = da_kernel.launches
        assert torch.equal(decode_attention_op(*args, window_slice=w), got)
        assert torch.equal(da_kernel.decode_attention(*args, window_slice=w), got)
        assert torch.equal(decode_attention_op(*args, use_kernel=False, window_slice=w), got)
        assert da_kernel.launches == before
        if cur < s:
            full = decode_attention_plain(*args, window=w)
            np.testing.assert_allclose(got.numpy(), full.numpy(), **OP_TOL)


def test_window_slice_comes_without_a_window():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 1, 2, 8, 16))
    with pytest.raises(ValueError, match="window"):
        decode_attention_plain(q, k, v, 5, 0.3, None, 4, 4)
    with pytest.raises(ValueError, match="window_slice"):
        da_kernel.decode_attention(q, k, v, torch.tensor(5, dtype=torch.int32), 0.3, None, 4, 4)
    with pytest.raises(ValueError, match="window_slice"):
        da_kernel.decode_attention(q, k, v, torch.tensor(5, dtype=torch.int32), 0.3,
                                   window_slice=0)


def test_the_split_plan_covers_the_slice():
    """The kernel sweeps ``min(window, S)`` keys: the persistent grid's
    plan covers them, and at gemma2-27b's decode shape the window's 4096
    keys (32 tiles a pair) are spread over all 132 blocks, 7 or 8 tiles
    each, where a full read's plan would give each block the whole cache's
    share."""
    for pairs, keys, grid in ((32, 4096, 132), (2, 16, 264), (512, 4096, 132)):
        plan = da_kernel.work_plan(pairs, keys, 64, grid)
        tiles = -(-keys // 64)
        assert sum(n for segs in plan for _, n in segs) == pairs * tiles
    sk = da_kernel.stage_keys(128)
    plan = da_kernel.work_plan(32, 4096, sk, 132)
    assert {sum(n for _, n in segs) for segs in plan} == {7, 8}
    full = da_kernel.work_plan(32, 32768, sk, 132)
    assert min(sum(n for _, n in segs) for segs in full) > 8 * 7
