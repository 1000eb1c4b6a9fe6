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


#: (d, stage keys, stages): 64 KB stages of 64 to 256 box rows
RINGS = [(256, 64, 3), (128, 128, 3), (64, 256, 3), (32, 256, 6), (16, 256, 12), (8, 256, 16)]
#: a block may have 227 KB (232,448 bytes) of shared memory
BLOCK_SMEM = 232_448


@pytest.mark.parametrize("d,keys,stages", RINGS)
def test_ring_sizing(d, keys, stages):
    """A stage holds the K and V rows of 64 to 256 positions (a box's
    rows), ~64 KB: three stages in ~200 KB at d = 128 and 256, one block an
    SM."""
    assert da_kernel.stage_keys(d) == keys
    assert da_kernel.ring_stages(d, keys) == stages
    assert keys % (16 * da_kernel.TC_WARPS) == 0  # whole 16-key steps for every key slot
    assert da_kernel.stage_bytes(d, keys) == keys * 4 * d
    smem = da_kernel.smem_bytes(d, stages, keys)
    assert smem <= BLOCK_SMEM < 2 * (smem + 1024) or d <= 32
    # every part of a stage (and every box of it) starts on 1024 bytes,
    # the 128-byte swizzle's period
    box = keys * da_kernel.box_row_bytes(d)
    assert box % 1024 == 0 and da_kernel.stage_bytes(d, keys) % 1024 == 0


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 256])
def test_box_and_swizzle_arithmetic(d):
    """The tensor copy's layout of a stage part (``smem_offset``): boxes of
    min(d, 64) columns, rows of min(2d, 128) bytes, the 16-byte chunk w of
    row r at w ^ x(r).  It is a bijection onto the part's bytes, it is the
    TMA swizzle (bits 4-6 of a byte offset XORed by bits 7-9, masked to the
    swizzle's span), the kernel's per-lane ldmatrix addresses reach it, and
    every 8 x 8 operand's eight rows fall in distinct 16-byte bank groups."""
    keys = da_kernel.stage_keys(d)
    bb = da_kernel.box_row_bytes(d)
    assert bb == min(2 * d, 128) and (2 * d) % bb == 0
    offs = np.array([[da_kernel.smem_offset(d, keys, r, c) for c in range(d)]
                     for r in range(keys)])
    assert sorted((offs // 2).ravel().tolist()) == list(range(keys * d))  # a bijection
    mask = bb // 16 - 1
    for r in range(0, keys, 7):
        for c in range(0, d, 3):
            box, within = divmod(2 * c, bb)
            packed = r * bb + within  # the unswizzled offset inside the box
            assert offs[r, c] == box * keys * bb + (packed ^ (((packed >> 7) & mask) << 4))
    # the kernel's lane arithmetic (decode_tc_kernel: key_k, x_k, key_v, x_v)
    chunks = bb // 16
    for lane in range(32):
        key_k = ((lane >> 3) & 1 if d < 16 else lane >> 4) * 8 + (lane & 7)
        key_v = ((lane >> 3) & 1) * 8 + (lane & 7)
        h_k = 0 if d < 16 else (lane >> 3) & 1
        h_v = 0 if d < 16 else lane >> 4
        x_k = h_k ^ ((key_k * bb >> 7) & (chunks - 1))
        x_v = h_v ^ ((key_v * bb >> 7) & (chunks - 1))
        for kb in range(0, keys, 16):
            for kk in range(max(1, d // 16)):
                got = ((2 * kk) // chunks * keys * bb + (kb + key_k) * bb
                       + ((((2 * kk) % chunks) ^ x_k) << 4))
                assert got == offs[kb + key_k, (2 * kk + h_k) * 8]
            for nt in range(0, max(1, d // 8), 2):
                got = (nt // chunks * keys * bb + (kb + key_v) * bb
                       + (((nt % chunks) ^ x_v) << 4))
                assert got == offs[kb + key_v, (nt + h_v) * 8]
    # an ldmatrix operand: eight consecutive keys from a multiple of 8, one
    # 16-byte chunk: eight distinct bank groups
    for r0 in range(0, keys, 8):
        for c in range(0, d, 8):
            groups = {(offs[r0 + i, c] // 16) % 8 for i in range(8)}
            assert len(groups) == 8, (r0, c)


@pytest.mark.parametrize("pairs,n_keys,keys,grid", [
    (128, 32768, 128, 132), (128, 32752, 128, 264), (64, 32768, 64, 132), (16, 31767, 128, 132),
    (32, 4096, 128, 132), (1, 100, 128, 132), (3, 1, 64, 132), (7, 2081, 64, 13),
    (1, 1 << 20, 256, 132), (200, 700, 256, 264)])
def test_work_plan_covers_every_key(pairs, n_keys, keys, grid):
    """The persistent grid's plan: every tile of every pair exactly once,
    in order, in non-empty segments; the blocks' tile counts differ by at
    most one, and no block is idle while there are tiles for it; a pair
    spans at most ``max_segments`` blocks, and the segment index that the
    kernel computes from the pair's first tile stays below it."""
    plan = da_kernel.work_plan(pairs, n_keys, keys, grid)
    tiles = -(-n_keys // keys)
    total = pairs * tiles
    assert len(plan) == grid
    seen = [p for segs in plan for p, n in segs for _ in range(n)]
    assert seen == [p for p in range(pairs) for _ in range(tiles)]
    assert all(n >= 1 for segs in plan for _, n in segs)
    busy = min(grid, total)  # the first min(grid, total) blocks, a tile or more each
    counts = [sum(n for _, n in segs) for segs in plan]
    assert max(counts[:busy]) - min(counts[:busy]) <= 1 and min(counts[:busy]) >= 1
    assert not any(counts[busy:])
    for p in range(pairs):  # a pair's segments: consecutive blocks, numbered from 0
        blocks = [i for i, segs in enumerate(plan) if any(q == p for q, _ in segs)]
        assert blocks == list(range(blocks[0], blocks[-1] + 1))
        assert blocks[0] == da_kernel.tile_owner(p * tiles, total, grid)
        assert len(blocks) <= da_kernel.max_segments(pairs, grid)
    for block, segs in enumerate(plan):
        first, end = da_kernel.tile_range(block, total, grid)
        assert end - first == counts[block]
        assert all(da_kernel.tile_owner(t, total, grid) == block for t in range(first, end))


#: the registry's decode geometries on the card's paths (chip_smoke.py):
#: name, batch, S, kept keys (cur + 1, or the window slice)
REGISTRY_DECODE = [("gemma-2b", 64, 32768, 32768), ("gemma2-27b", 2, 32768, 4096),
                   ("glm4-9b", 8, 32768, 32768 - 16), ("llama4-scout-17b-a16e", 16, 32768, 32752),
                   ("arctic-480b", 16, 32768, 32752)]


@pytest.mark.parametrize("name,batch,s,kept", REGISTRY_DECODE)
@pytest.mark.parametrize("fill", ["decode", "half"])
def test_every_registry_geometry_fills_every_sm(name, batch, s, kept, fill):
    """Every registry LM's decode call keeps all 132 SMs of an H100 busy
    with even work, at its decode fill level and with the cache half full:
    each block within one stage of the mean, where one block a pair left 4
    of 132 SMs idle at llama4-scout's 128 pairs; a pair's segments are
    consecutive blocks; the last tile's box re-reads less than a stage a
    pair."""
    from repro_torch.configs import get_arch

    cfg = get_arch(name).config
    hkv, d = cfg.n_kv_heads, cfg.head_dim
    if fill == "half":
        kept = min(kept, s // 2 + 37)
    keys = da_kernel.stage_keys(d)
    stages = da_kernel.ring_stages(d, keys)
    assert da_kernel.smem_bytes(d, stages, keys) <= BLOCK_SMEM
    grid, pairs = 132, batch * hkv
    plan = da_kernel.work_plan(pairs, kept, keys, grid)
    counts = np.array([sum(n for _, n in segs) for segs in plan])
    assert counts.min() >= 1 and counts.max() - counts.min() <= 1
    tiles = -(-kept // keys)
    assert tiles * keys - kept < keys
    assert counts.sum() == pairs * tiles
    for p in range(pairs):
        blocks = [i for i, segs in enumerate(plan) if any(q == p for q, _ in segs)]
        assert blocks == list(range(blocks[0], blocks[-1] + 1))


def test_split_plan_of_the_bf16_kernel_at_the_decode_shape():
    """gemma-2b's decode shape in bf16: 64 pairs over 32768 keys, stages of
    64 keys, 512 tiles a pair: 32768 tiles over 132 blocks, 248 or 249
    each (the first design ran 2 chunks a pair on 128 of the 132 SMs);
    a pair spans at most 4 blocks."""
    keys = da_kernel.stage_keys(256)
    assert keys == 64 and da_kernel.head_slots(8, 256) == 1
    plan = da_kernel.work_plan(64, 32768, keys, 132)
    counts = {sum(n for _, n in segs) for segs in plan}
    assert counts == {248, 249}
    assert da_kernel.max_segments(64, 132) == 4
    assert max(len(segs) for segs in plan) == 2
