"""The port's decode-attention op on the CPU (its plain PyTorch version)
against the JAX package's: the Pallas kernel in interpret mode
(``decode_attention_op(..., use_kernel=True, interpret=True)``) and the jnp
oracle ``decode_attention_ref``.

Inputs are drawn as ``tests/test_kernels.py`` draws them, on its five sweep
shapes, with its tolerances: 2e-6 in f32, 3e-2 in bf16 (one bf16 rounding
of an output of magnitude ~1 is 4e-3, and the two sides sum in different
orders before it).  The CUDA kernel itself runs only on a card:
``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention_op as jax_op  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_op,
    decode_attention_plain,
)

SHAPES = [
    (2, 2, 4, 64, 256, None, None),
    (1, 1, 8, 128, 1024, 50.0, 300),
    (3, 4, 1, 128, 777, None, None),
    (2, 1, 4, 256, 100, 30.0, 64),
    (1, 2, 2, 64, 513, None, 128),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-6), "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _case(seed, b, hkv, g, d, s):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d)))


def _jax(arrays, jdt):
    return tuple(jnp.asarray(a).astype(jdt) for a in arrays)


def _torch(arrays, tdt):
    return tuple(torch.from_numpy(a).to(tdt) for a in arrays)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,hkv,g,d,s,cap,win", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_and_op_equal_the_jax_kernel_and_oracle(b, hkv, g, d, s, cap, win, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _case(s * 7 + d, b, hkv, g, d, s)
    cur = s - 7
    qj, kj, vj = _jax(arrays, jdt)
    want_kernel = jax_op(qj, kj, vj, cur, scale=d**-0.5, softcap=cap, window=win,
                         use_kernel=True, interpret=True)
    want_ref = decode_attention_ref(qj, kj, vj, jnp.asarray(cur), d**-0.5, cap, win)
    q, k, v = _torch(arrays, tdt)
    before = da_kernel.launches
    got_op = decode_attention_op(q, k, v, torch.tensor(cur, dtype=torch.int32), d**-0.5, cap, win)
    got_plain = decode_attention_plain(q, k, v, cur, d**-0.5, cap, win)
    assert da_kernel.launches == before  # the CPU runs the plain version
    assert got_op.dtype == tdt and got_op.shape == (b, hkv, g, d)
    for got in (got_op, got_plain):
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_partial_fill():
    """tests/test_kernels.py's case: only the first cur_len + 1 slots may
    influence the output; poisoning the rest changes nothing."""
    q, k, v = _torch(_case(3, 1, 1, 2, 64, 512), torch.float32)
    cur = 100
    o1 = decode_attention_op(q, k, v, cur, scale=64**-0.5)
    k2, v2 = k.clone(), v.clone()
    k2[:, cur + 1:] = 1e9
    v2[:, cur + 1:] = -1e9
    o2 = decode_attention_op(q, k2, v2, cur, scale=64**-0.5)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-5, atol=1e-5)
    want = decode_attention_ref(*_jax((q.numpy(), k.numpy(), v.numpy()), jnp.float32),
                                jnp.asarray(cur), 64**-0.5)
    np.testing.assert_allclose(o1.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("cur,win", [(40, None), (40, 4), (40, 20), (31, 1), (0, None), (0, 8)])
def test_clamp_at_and_past_the_cache_end(cur, win):
    """cur >= S (every slot valid; a window past the cache masks every slot
    and the softmax is uniform over S), cur 0, window 1: as the reference."""
    arrays = _case(11, 2, 2, 4, 64, 32)
    q, k, v = _torch(arrays, torch.float32)
    got = decode_attention_op(q, k, v, cur, 0.125, 30.0, win)
    want = decode_attention_ref(*_jax(arrays, jnp.float32), jnp.asarray(cur), 0.125, 30.0, win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)


def test_use_kernel_false_runs_the_plain_version():
    q, k, v = _torch(_case(4, 2, 1, 8, 32, 50), torch.bfloat16)
    got = decode_attention_op(q, k, v, 20, 0.2, None, 16, use_kernel=False)
    assert torch.equal(got, decode_attention_plain(q, k, v, 20, 0.2, None, 16))


@pytest.mark.parametrize("pairs,s", [(64, 32768), (1, 100), (32, 8200), (1, 33), (128, 1),
                                     (4, 2081), (1, 1 << 20)])
def test_split_plan_covers_the_cache(pairs, s):
    chunk, n_split = da_kernel.split_plan(pairs, s, 3 * 132)
    assert chunk % da_kernel.TILE == 0 and chunk >= da_kernel.TILE
    assert (n_split - 1) * chunk < s <= n_split * chunk  # no empty trailing chunk
    assert 1 <= n_split <= da_kernel.MAX_SPLITS


def test_split_plan_fills_whole_waves():
    """gemma-2b's decode shape, 64 (batch, kv head) pairs over 32768 keys
    with 396 resident blocks: 6 chunks of 171 tiles run as one wave (173
    tiles' time with a block's fixed cost), where 9 chunks of 114 tiles
    would take two waves (232)."""
    chunk, n_split = da_kernel.split_plan(64, 32768, 396)
    assert (chunk, n_split) == (171 * da_kernel.TILE, 6)
    assert da_kernel.split_plan(1, 1 << 20, 396)[1] == 256  # one pair: every split runs


def test_wrapper_checks_its_operands_on_the_cpu():
    q, k, v = _torch(_case(5, 1, 1, 2, 16, 8), torch.float32)
    with pytest.raises(TypeError):
        da_kernel.decode_attention(q, k.bfloat16(), v, 3, 0.1)
    with pytest.raises(TypeError):
        da_kernel.decode_attention(q.double(), k.double(), v.double(), 3, 0.1)
    with pytest.raises(ValueError):
        da_kernel.decode_attention(q, k[:, :, :, :8].contiguous(), v, 3, 0.1)
    with pytest.raises(ValueError):
        da_kernel.decode_attention(q, k, v, 3, 0.1, window=0)
    with pytest.raises(ValueError):
        da_kernel.decode_attention(q, k, v, 3, 0.1, softcap=-1.0)


@pytest.mark.parametrize("g,d,slots", [(8, 256, 1), (16, 256, 2), (1, 128, 1), (16, 128, 2),
                                       (32, 128, 4), (24, 128, 4), (64, 64, 4), (32, 64, 2),
                                       (2, 16, 1), (256, 16, 4), (512, 8, 4), (3, 8, 1)])
def test_head_slots_hold_every_group(g, d, slots):
    """The bf16 kernel's four consumer warps split the head groups (eight
    heads each) into 1, 2 or 4 head slots, each warp holding at most
    max(1, 128 // d) groups; the rest of the four split the keys."""
    assert da_kernel.head_slots(g, d) == slots
    groups = -(-g // 8)
    assert -(-groups // slots) <= max(1, 128 // d)
    assert da_kernel.TC_WARPS % slots == 0


def test_every_shape_the_wrapper_takes_has_head_slots():
    for d in (8, 16, 32, 64, 128, 256):
        for g in range(1, da_kernel.MAX_GROUP_WIDTH // d + 1):
            groups, slots = -(-g // 8), da_kernel.head_slots(g, d)
            assert -(-groups // slots) <= max(1, 128 // d), (g, d)


@pytest.mark.parametrize("h_slots,keys256,stages", [(1, 64, 3), (2, 32, 6), (4, 16, 12)])
def test_ring_sizing(h_slots, keys256, stages):
    """A stage holds eight 1 KB units of K and of V for each key slot: 64
    keys at d = 256 with one head slot, three stages in ~200 KB of the 227
    KB (232,448 bytes) a block may have."""
    assert da_kernel.stage_keys(256, h_slots) == keys256
    for d in (8, 16, 32, 64, 128, 256):
        keys = da_kernel.stage_keys(d, h_slots)
        assert keys * 2 * d == (da_kernel.TC_WARPS // h_slots) * 8 * da_kernel.UNIT_ROW_BYTES
        assert keys % 16 == 0  # whole 16-key mma steps for every warp
    assert da_kernel.ring_stages(h_slots) == stages
    ring = da_kernel.ring_stages(h_slots) * (da_kernel.stage_bytes(h_slots) + 16)
    assert ring <= da_kernel.RING_BYTES + 16 * stages <= 232_448
    assert da_kernel.stage_bytes(h_slots) % 16 == 0 and da_kernel.UNIT_BYTES % 128 == 16


def test_split_plan_of_the_bf16_kernel_at_the_decode_shape():
    """gemma-2b's decode shape in bf16: 64 pairs over 32768 keys, one block
    an SM (132 slots), stages of 64 keys: two chunks of 16384 keys, one
    wave of 128 blocks (three chunks would take two waves)."""
    tile = da_kernel.stage_keys(256, da_kernel.head_slots(8, 256))
    assert da_kernel.split_plan(64, 32768, 132, tile, da_kernel.TC_BLOCK_COST) == (16384, 2)
    for pairs, s in ((1, 100), (32, 8200), (4, 2081), (128, 1)):
        chunk, n_split = da_kernel.split_plan(pairs, s, 132, tile, da_kernel.TC_BLOCK_COST)
        assert chunk % tile == 0 and (n_split - 1) * chunk < s <= n_split * chunk
