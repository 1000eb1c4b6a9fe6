"""GQA flash-decode attention over a KV cache: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attention.kernel.
decode_attention`` (``src/repro/kernels/decode_attention/kernel.py:90``)
with the kernels of ``repro_torch/csrc/decode_attention.cu``: S is split
across blocks (flash-decoding) and the partial softmax states are merged
by a second launch (``decode_merge_kernel``).  In bf16, the decode path's
type, ``decode_tc_kernel`` runs q.k and p.v on the tensor cores, fed by a
producer warp's bulk copies through a ring of ``mbarrier`` stages; in f32
``decode_split_kernel`` runs on the CUDA cores (the tensor cores would
round f32 to TF32).  The dtype chooses; there is no switch.  The source
says what bounds it on an H100 (bytes) and what the design does about it.

With ``window_slice`` (the ``decode_window_slice`` lever on a local
layer) the split is planned over the ``w = min(window_slice, S)`` keys of
the window slice, not over S: each block computes the slice's start from
``cur_len`` on the device and reads rows ``start + j`` (the batch stride
stays S).  Without it every launch is as before.

A tensor on the CPU (or on ``meta``, the dry-run's shapes) runs the plain version
(:func:`repro_torch.kernels.decode_attention.ref.decode_attention_plain`);
a tensor on the card launches the kernel or raises.  :data:`launches`
counts calls that launched the kernel (one per call: the split and the
merge launch together).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build
from ..cache_ops.kernel import require
from .ref import decode_attention_plain

#: calls that launched the kernel through :func:`decode_attention` (CPU
#: calls run the plain version and do not count)
launches = 0

#: f32 path: keys per shared-memory tile, as ``kTile`` in the CUDA source
TILE = 32
#: most blocks one (batch, kv head) pair's S is split over
MAX_SPLITS = 256
#: f32 path: a block's fixed cost (loading q, the first tile's copy, writing
#: its partial state), in tiles' time, for :func:`split_plan`
BLOCK_COST = 2
#: bf16 path: consumer warps (``kTcWarps``), which split a stage's keys
#: (key slots) and the head groups (head slots); the bytes of consecutive
#: positions one copy moves (``kUnitRowBytes``) and the unit's shared
#: bytes with its padding (``kUnitBytes``); a warp takes eight units of K
#: and eight of V a stage
TC_WARPS = 4
UNIT_ROW_BYTES = 1024
UNIT_BYTES = UNIT_ROW_BYTES + 16
#: bf16 path: a block's fixed cost in stages' time (a stage is ~64 KB with
#: four key slots, ~2.6 us of one SM's share of the HBM rate): loading q
#: and the barriers, the first stage's latency, writing its partial states
TC_BLOCK_COST = 1
#: bf16 path: the ring's shared memory, ~200 KB of the 227 KB a block may
#: have, in 2 to 16 stages (``kTcMinStages``, ``kTcMaxStages``)
RING_BYTES = 200 * 1024
MIN_STAGES, MAX_STAGES = 2, 16
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
def _entry():
    fn = _build.library("decode_attention").decode_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _slots(index: int, g: int, d: int, dtype: int, stages: int, h_slots: int) -> int:
    """Blocks of the split kernel the card holds at once for these shapes."""
    lib = _build.library("decode_attention")
    per_sm = lib.decode_attention_blocks_per_sm(g, d, dtype, stages, h_slots)
    if per_sm < 1:
        raise RuntimeError(f"decode_attention: no occupancy for G={g}, d={d}")
    return per_sm * torch.cuda.get_device_properties(index).multi_processor_count


def head_slots(g: int, d: int) -> int:
    """Consumer warps that split the bf16 kernel's head groups (eight query
    heads each): a warp holds at most ``max(1, 128 // d)`` groups
    (``tc_max_groups``), so 1, 2 or 4; the other factor of
    :data:`TC_WARPS` splits each stage's keys (key slots)."""
    groups = -(-g // 8)
    need = -(-groups // max(1, 128 // d))
    return next(n for n in (1, 2, 4) if n >= need)


def stage_keys(d: int, h_slots: int) -> int:
    """Keys of one bf16 ring stage with ``h_slots`` head slots: eight 1 KB
    units of positions for each key slot (``tc_stage_keys``; 64 at d = 256
    with one head slot)."""
    return TC_WARPS // h_slots * 8 * (UNIT_ROW_BYTES // (2 * d))


def stage_bytes(h_slots: int) -> int:
    """Shared bytes of one bf16 ring stage: eight K and eight V units for
    each key slot (``tc_stage_bytes``); the units are padded by 16 bytes, so
    an ldmatrix operand's eight rows, one from each unit, fall in distinct
    banks."""
    return 2 * 8 * (TC_WARPS // h_slots) * UNIT_BYTES


def ring_stages(h_slots: int) -> int:
    """Stages of the bf16 ring: as many as :data:`RING_BYTES` holds, within
    [:data:`MIN_STAGES`, :data:`MAX_STAGES`] (3 with one head slot: 195 KB,
    two stages in flight while the consumers read the third)."""
    return max(MIN_STAGES, min(MAX_STAGES, RING_BYTES // stage_bytes(h_slots)))


@functools.lru_cache(maxsize=None)
def split_plan(pairs: int, s: int, slots: int, tile: int = TILE,
               block_cost: int = BLOCK_COST) -> Tuple[int, int]:
    """``(chunk, n_split)``: the keys each block sweeps (a multiple of
    ``tile``) and the blocks each of the ``pairs`` (batch, kv head)
    pairs is split over, for ``s`` keys (the cache's S, or the window
    slice's width).  With ``slots`` blocks resident at once, the run
    takes about (waves) x (tiles per block + ``block_cost`` for a block's
    start and its partial write): the split minimises that, the fewest
    blocks among equals.  Fixed by the shapes alone: the fill level
    ``cur_len`` lives on the device, and blocks wholly past it return at
    once.  The f32 kernel's tile is :data:`TILE` keys, the bf16 kernel's
    a ring stage, :func:`stage_keys` (with :data:`TC_BLOCK_COST`)."""
    tiles = -(-s // tile)
    best_cost, best_n = None, 1
    for n in range(1, min(MAX_SPLITS, tiles) + 1):
        cost = -(-pairs * n // slots) * (-(-tiles // n) + block_cost)
        if best_cost is None or cost < best_cost:
            best_cost, best_n = cost, n
    chunk = -(-tiles // best_n) * tile
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
    dtype = _DTYPES[q.dtype]
    if dtype == 0:
        stages, h_slots, parts_per_split, tile, cost = 0, 1, 1, TILE, BLOCK_COST
    else:
        h_slots = head_slots(g, d)
        stages, tile, cost = ring_stages(h_slots), stage_keys(d, h_slots), TC_BLOCK_COST
        parts_per_split = TC_WARPS // h_slots
    with torch.cuda.device(dev):
        slots = _slots(index, g, d, dtype, stages, h_slots)
    slice_w = 0 if window_slice is None else min(int(window_slice), s)
    chunk, n_split = split_plan(b * hkv, slice_w or s, slots, tile, cost)
    n_part = n_split * parts_per_split
    out = torch.empty_like(q)
    part_ml = torch.empty((b * hkv, n_part, 2, g), dtype=torch.float32, device=dev)
    part_acc = torch.empty((b * hkv, n_part, g, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cur_len.data_ptr(),
            b, s, hkv, g, d, float(scale), float(softcap or 0.0), int(window or 0), slice_w,
            dtype, chunk, n_split, stages, h_slots,
            part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "decode_attention")
    launches += 1
    return out
