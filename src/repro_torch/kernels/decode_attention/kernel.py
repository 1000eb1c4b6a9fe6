"""GQA flash-decode attention over a KV cache: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attention.kernel.
decode_attention`` (``src/repro/kernels/decode_attention/kernel.py:90``)
with the kernels of ``repro_torch/csrc/decode_attention.cu``: partial
softmax states over pieces of S, merged by a second launch
(``decode_merge_kernel``).  In bf16, the decode path's type,
``decode_tc_kernel`` runs q.k and p.v on the tensor cores on a persistent
grid (every pair's kept keys cut into ring stages, the stages of all pairs
divided evenly over the blocks), fed by TMA tensor copies of the strided
``(B, S, Hkv, d)`` rows through a ring of ``mbarrier`` stages; the wrapper
encodes the two tensor maps and keeps them in a table.  In f32
``decode_split_kernel`` runs on the CUDA cores (the tensor cores would
round f32 to TF32), S split into chunks a pair.  The dtype chooses; there
is no switch.  The source says what bounds it on an H100 (bytes) and what
the design does about it.

With ``window_slice`` (the ``decode_window_slice`` lever on a local
layer) the kernels sweep the ``w = min(window_slice, S)`` keys of the
window slice, not S: they compute the slice's start from ``cur_len`` on
the device and read rows ``start + j`` (the batch stride stays S).

A tensor on the CPU (or on ``meta``, the dry-run's shapes) runs the plain version
(:func:`repro_torch.kernels.decode_attention.ref.decode_attention_plain`);
a tensor on the card launches the kernel or raises: there is no fallback
when a tensor map cannot be encoded or a launch is refused.
:data:`launches` counts calls that launched the kernel (one per call: the
kernel and the merge launch together).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from .. import _build
from ..cache_ops.kernel import require
from .ref import decode_attention_plain

#: calls that launched the kernel through :func:`decode_attention` (CPU
#: calls run the plain version and do not count)
launches = 0

#: f32 path: keys per shared-memory tile, as ``kTile`` in the CUDA source
TILE = 32
#: f32 path: most blocks one (batch, kv head) pair's S is split over
MAX_SPLITS = 256
#: f32 path: a block's fixed cost (loading q, the first tile's copy, writing
#: its partial state), in tiles' time, for :func:`split_plan`
BLOCK_COST = 2
#: bf16 path: consumer warps (``kTcWarps``), which split a stage's keys
#: (key slots) and the head groups (head slots)
TC_WARPS = 4
#: bf16 path: the widest box row, 64 bf16 columns (the 128-byte swizzle's
#: span); a wider K or V row is several boxes
BOX_ROW_BYTES = 128
#: bf16 path: a ring stage's bytes (K and V); a box holds 64 to 256
#: positions (``tc_takes``)
STAGE_BYTES = 64 * 1024
MIN_STAGE_KEYS, MAX_STAGE_KEYS = 64, 256
#: bf16 path: the ring's shared memory, ~200 KB of the 227 KB a block may
#: have (one block an SM), in 2 to 16 stages (``kTcMinStages``,
#: ``kTcMaxStages``)
RING_BYTES = 200 * 1024
MIN_STAGES, MAX_STAGES = 2, 16
#: bf16 path: encoded tensor maps kept, keyed by (pointer, shape, box)
MAP_TABLE = 1024
#: what the kernels take: d dividing 256, rows a multiple of 16 bytes (the
#: copies move 16-byte pieces), G*d <= 4096 (the f32 kernel's 256 threads
#: hold at most 16 accumulators each), K and V 16-byte aligned.  Every LM
#: of the registry has head_dim 16, 128 or 256.
THREADS = 256
MAX_GROUP_WIDTH = 4096

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _entry(dtype: int):
    lib = _build.library("decode_attention")
    if dtype == 0:
        fn = lib.decode_attention_launch_f32
        fn.argtypes = [_P, _P, _P, _P] + [_I] * 5 + [_F, _F] + [_I] * 4 + [_P] * 4
    else:
        fn = lib.decode_attention_launch_bf16
        fn.argtypes = [_P, _P, _P, _P] + [_I] * 5 + [_F, _F] + [_I] * 7 + [_P] * 5
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _slots(index: int, g: int, d: int, dtype: int, stages: int, h_slots: int,
           keys: int = 0) -> int:
    """Blocks of the kernel the card holds at once for these shapes."""
    lib = _build.library("decode_attention")
    per_sm = lib.decode_attention_blocks_per_sm(g, d, dtype, stages, h_slots, keys)
    if per_sm < 1:
        raise RuntimeError(f"decode_attention: no occupancy for G={g}, d={d}")
    return per_sm * torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=MAP_TABLE)
def _tensor_map(ptr: int, b: int, s: int, hkv: int, d: int, keys: int) -> ctypes.Array:
    """The bf16 kernel's ``CUtensorMap`` (128 bytes) of a K or V cache at
    ``ptr``, ``(b, s, hkv, d)`` bf16, with boxes of :func:`stage_keys`
    rows.  A map is a pure function of its key, so a freed and reused
    address reads the right map."""
    fn = _build.library("decode_attention").decode_attention_encode_map
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _I]
    fn.restype = _I
    buf = (ctypes.c_ubyte * 128)()
    err = fn(ctypes.addressof(buf), ptr, b, s, hkv, d, keys)
    if err != 0:
        raise RuntimeError(f"decode_attention: cuTensorMapEncodeTiled failed ({err}) for "
                           f"(B, S, Hkv, d) = {(b, s, hkv, d)}, box of {keys} positions")
    return buf


def head_slots(g: int, d: int) -> int:
    """Consumer warps that split the bf16 kernel's head groups (eight query
    heads each): a warp holds at most ``max(1, 128 // d)`` groups
    (``tc_max_groups``), so 1, 2 or 4; the other factor of
    :data:`TC_WARPS` splits each stage's keys (key slots)."""
    groups = -(-g // 8)
    need = -(-groups // max(1, 128 // d))
    return next(n for n in (1, 2, 4) if n >= need)


def stage_keys(d: int) -> int:
    """Positions of one bf16 ring stage: :data:`STAGE_BYTES` of K and V
    rows, within a box's 64 to 256 rows (128 at d = 128, 64 at d = 256)."""
    return max(MIN_STAGE_KEYS, min(MAX_STAGE_KEYS, STAGE_BYTES // (4 * d)))


def stage_bytes(d: int, keys: int) -> int:
    """Shared bytes of one bf16 ring stage of ``keys`` positions: the K
    part, then the V part (``tc_stage_bytes``)."""
    return 2 * keys * 2 * d


def ring_stages(d: int, keys: int) -> int:
    """Stages of the bf16 ring: as many as :data:`RING_BYTES` holds, within
    [:data:`MIN_STAGES`, :data:`MAX_STAGES`] (3 of 64 KB at d = 128 and
    256: two in flight while the consumers read the third)."""
    return max(MIN_STAGES, min(MAX_STAGES, RING_BYTES // stage_bytes(d, keys)))


def exchange_bytes(d: int) -> int:
    """Shared bytes where a bf16 block's key slots combine their states at
    a segment's end (``tc_exchange_bytes``): three warps' lanes, each with
    m, l and two columns of each 8-column n-tile for every head group it
    holds."""
    return (TC_WARPS - 1) * 32 * max(1, 128 // d) * (2 + d // 4) * 4


def smem_bytes(d: int, stages: int, keys: int) -> int:
    """A bf16 block's dynamic shared memory (``tc_smem_bytes``): the ring,
    1024 bytes of slack to align it, two barriers a stage, the key slots'
    exchange."""
    return 1024 + stages * (stage_bytes(d, keys) + 16) + exchange_bytes(d)


def box_row_bytes(d: int) -> int:
    """Bytes of a box row: a whole K or V row up to 128 bytes, else 128."""
    return min(2 * d, BOX_ROW_BYTES)


def smem_offset(d: int, keys: int, row: int, col: int) -> int:
    """Byte offset of element ``(row, col)`` of a stage's K (or V) part as
    the tensor copy lays it out: column box ``col // 64`` of ``keys`` rows,
    then the row, its 16-byte chunk XORed by the swizzle (``x_k`` and
    ``x_v`` in the kernel)."""
    bb = box_row_bytes(d)
    box, within = divmod(2 * col, bb)
    chunks = bb // 16
    x = (row * bb >> 7) & (chunks - 1)
    return box * keys * bb + row * bb + (((within // 16) ^ x) << 4) + within % 16


def tile_range(block: int, total: int, grid: int) -> Tuple[int, int]:
    """The tiles ``[first, end)`` block ``block`` of a persistent grid of
    ``grid`` takes from ``total`` (``Work::first``): the first ``min(grid,
    total)`` blocks share them evenly, the others get none."""
    grid = min(grid, total)
    if block >= grid:
        return total, total
    return -(-block * total // grid), -(-(block + 1) * total // grid)


def tile_owner(tile: int, total: int, grid: int) -> int:
    """The block that takes tile ``tile`` (``Work::owner``)."""
    return tile * min(grid, total) // total


def max_segments(pairs: int, grid: int) -> int:
    """Most blocks one pair's tiles can span on a grid of ``grid``: the
    partial states the wrapper allocates a pair."""
    return -(-grid // pairs) + 1


def work_plan(pairs: int, n_keys: int, keys: int, grid: int) -> List[List[Tuple[int, int]]]:
    """What each block of the bf16 kernel sweeps when the mask keeps
    ``n_keys`` positions: a list a block of ``(pair, tiles)``, in order.
    The kernel computes the same on the device from ``cur_len``."""
    tiles = -(-n_keys // keys)
    total = pairs * tiles
    plan = []
    for block in range(grid):
        first, end = tile_range(block, total, grid)
        segs: List[Tuple[int, int]] = []
        for t in range(first, end):
            if segs and segs[-1][0] == t // tiles:
                segs[-1] = (segs[-1][0], segs[-1][1] + 1)
            else:
                segs.append((t // tiles, 1))
        plan.append(segs)
    return plan


@functools.lru_cache(maxsize=None)
def split_plan(pairs: int, s: int, slots: int) -> Tuple[int, int]:
    """f32: ``(chunk, n_split)``: the keys each block sweeps (a multiple of
    :data:`TILE`) and the blocks each of the ``pairs`` (batch, kv head)
    pairs is split over, for ``s`` keys (the cache's S, or the window
    slice's width).  With ``slots`` blocks resident at once, the run
    takes about (waves) x (tiles per block + :data:`BLOCK_COST` for a
    block's start and its partial write): the split minimises that, the
    fewest blocks among equals.  Fixed by the shapes alone: the fill level
    ``cur_len`` lives on the device, and blocks wholly past it return at
    once."""
    tiles = -(-s // TILE)
    best_cost, best_n = None, 1
    for n in range(1, min(MAX_SPLITS, tiles) + 1):
        cost = -(-pairs * n // slots) * (-(-tiles // n) + BLOCK_COST)
        if best_cost is None or cost < best_cost:
            best_cost, best_n = cost, n
    chunk = -(-tiles // best_n) * TILE
    return chunk, -(-s // chunk)


def check_args(q, k, v) -> Tuple[int, int, int, int, int]:
    """Validate the operands the kernel takes; returns ``(B, Hkv, G, d, S)``."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(
            f"q must be (B, Hkv, G, d) and k, v (B, S, Hkv, d), got {tuple(q.shape)} "
            f"and {tuple(k.shape)}"
        )
    b, hkv, g, d = q.shape
    s = k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    dev = q.device
    require(q, "q", q.dtype, (b, hkv, g, d), dev)
    require(k, "k", q.dtype, (b, s, hkv, d), dev)
    require(v, "v", q.dtype, (b, s, hkv, d), dev)
    if s < 1 or d < 1 or g < 1:
        raise ValueError(f"empty cache or head: S={s}, G={g}, d={d}")
    return b, hkv, g, d, s


def decode_attention(
    q: torch.Tensor,  # (B, Hkv, G, d) f32 or bf16, contiguous
    k: torch.Tensor,  # (B, S, Hkv, d) like q
    v: torch.Tensor,  # (B, S, Hkv, d) like q
    cur_len: torch.Tensor,  # 0-d int32 on q's device: the query position
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    window_slice: Optional[int] = None,
) -> torch.Tensor:
    """``(B, Hkv, G, d)`` in q's dtype: each query head's softmax-weighted
    sum of V over the positions ``pos <= cur_len`` (and ``pos > cur_len -
    window``); with ``window_slice``, over those of the window slice only
    (module docstring).  Launches on the current stream and does not
    synchronise: ``cur_len`` is read on the device."""
    global launches
    b, hkv, g, d, s = check_args(q, k, v)
    dev = q.device
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if window_slice is not None and (int(window_slice) < 1 or window is not None):
        raise ValueError(f"window_slice must be >= 1 and come without a window, got "
                         f"{window_slice} with window {window}")
    if dev.type in ("cpu", "meta"):  # meta: shapes only (the dry-run)
        return decode_attention_plain(q, k, v, cur_len, scale, softcap, window, window_slice)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    require(cur_len, "cur_len", torch.int32, (), dev)
    if THREADS % d or d * q.element_size() % 16 or g * d > MAX_GROUP_WIDTH:
        raise ValueError(
            f"the kernel takes d dividing {THREADS} with rows a multiple of 16 bytes and "
            f"G*d <= {MAX_GROUP_WIDTH}; got d = {d} ({q.dtype}), G = {g}"
        )
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the kernel takes K and V 16-byte aligned")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    slice_w = 0 if window_slice is None else min(int(window_slice), s)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if q.dtype == torch.float32:
            slots = _slots(index, g, d, 0, 0, 1)
            chunk, n_split = split_plan(b * hkv, slice_w or s, slots)
            part_ml = torch.empty((b * hkv, n_split, 2, g), dtype=torch.float32, device=dev)
            part_acc = torch.empty((b * hkv, n_split, g, d), dtype=torch.float32, device=dev)
            err = _entry(0)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), cur_len.data_ptr(),
                b, s, hkv, g, d, float(scale), float(softcap or 0.0), int(window or 0), slice_w,
                chunk, n_split, part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), stream,
            )
        else:
            err = _launch_bf16(q, k, v, cur_len, index, float(scale), float(softcap or 0.0),
                               int(window or 0), slice_w, out, stream)
    _build.check(err, "decode_attention")
    launches += 1
    return out


def _launch_bf16(q, k, v, cur_len, index, scale, cap, window, slice_w, out, stream) -> int:
    """The bf16 kernel's launch: the ring and the persistent grid from the
    shapes, the two tensor maps from the table, one scratch buffer for the
    partial states and the pairs' segment counts."""
    b, hkv, g, d = q.shape
    s = k.shape[1]
    h_slots = head_slots(g, d)
    keys = stage_keys(d)
    stages = ring_stages(d, keys)
    grid = _slots(index, g, d, 1, stages, h_slots, keys)
    pairs = b * hkv
    segs = max_segments(pairs, grid)
    n_ml, n_acc = pairs * segs * 2 * g, pairs * segs * g * d
    scratch = torch.empty(n_ml + n_acc + pairs, dtype=torch.float32, device=q.device)
    base = scratch.data_ptr()
    k_map = _tensor_map(k.data_ptr(), b, s, hkv, d, keys)
    v_map = _tensor_map(v.data_ptr(), b, s, hkv, d, keys)
    return _entry(1)(
        ctypes.addressof(k_map), ctypes.addressof(v_map), q.data_ptr(), cur_len.data_ptr(),
        b, s, hkv, g, d, scale, cap, window, slice_w, keys, stages, h_slots, grid, segs,
        base, base + 4 * n_ml, base + 4 * (n_ml + n_acc), out.data_ptr(),
        stream,
    )
