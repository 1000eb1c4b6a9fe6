"""GQA flash-decode attention over a KV cache: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attention.kernel.
decode_attention`` (``src/repro/kernels/decode_attention/kernel.py:90``)
with ``decode_split_kernel`` + ``decode_merge_kernel`` in
``repro_torch/csrc/decode_attention.cu``: S is split across blocks
(flash-decoding) and the partial softmax states are merged by a second
launch.  The source says what bounds it on an H100 (bytes) and what the
design does about it.

A tensor on the CPU runs the plain version
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

#: keys per shared-memory tile, as ``kTile`` in the CUDA source
TILE = 32
#: most blocks one (batch, kv head) pair's S is split over
MAX_SPLITS = 256
#: a block's fixed cost (loading q, the first tile's copy, writing its
#: partial state), in tiles' time, for :func:`split_plan`
BLOCK_COST = 2
#: what the kernel takes: its 256 threads hold G*d accumulators, at most 16
#: each, one column of d each (d divides 256), and it copies K and V rows in
#: 16-byte pieces (rows a multiple of 16 bytes, K and V 16-byte aligned).
#: Every LM of the registry has head_dim 16, 128 or 256.
THREADS = 256
MAX_GROUP_WIDTH = 4096

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("decode_attention").decode_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _P, _P, _P, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _slots(index: int, g: int, d: int, dtype: int) -> int:
    """Blocks of the split kernel the card holds at once for these shapes."""
    per_sm = _build.library("decode_attention").decode_attention_blocks_per_sm(g, d, dtype)
    if per_sm < 1:
        raise RuntimeError(f"decode_attention: no occupancy for G={g}, d={d}")
    return per_sm * torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def split_plan(pairs: int, s: int, slots: int) -> Tuple[int, int]:
    """``(chunk, n_split)``: the keys each block sweeps (a multiple of
    :data:`TILE`) and the blocks each of the ``pairs`` (batch, kv head)
    pairs is split over.  With ``slots`` blocks resident at once, the run
    takes about (waves) x (tiles per block + :data:`BLOCK_COST` for a
    block's start and its partial write): the split minimises that, the
    fewest blocks among equals.  Fixed by the shapes alone: the fill
    level ``cur_len`` lives on the device, and blocks wholly past it
    return at once."""
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
) -> torch.Tensor:
    """``(B, Hkv, G, d)`` in q's dtype: each query head's softmax-weighted
    sum of V over the positions ``pos <= cur_len`` (and ``pos > cur_len -
    window``).  Launches on the current stream and does not synchronise:
    ``cur_len`` is read on the device."""
    global launches
    b, hkv, g, d, s = check_args(q, k, v)
    dev = q.device
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, cur_len, scale, softcap, window)
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
    with torch.cuda.device(dev):
        slots = _slots(index, g, d, _DTYPES[q.dtype])
    chunk, n_split = split_plan(b * hkv, s, slots)
    out = torch.empty_like(q)
    part_ml = torch.empty((b * hkv, n_split, 2, g), dtype=torch.float32, device=dev)
    part_acc = torch.empty((b * hkv, n_split, g, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cur_len.data_ptr(),
            b, s, hkv, g, d, float(scale), float(softcap or 0.0), int(window or 0),
            _DTYPES[q.dtype], chunk, n_split,
            part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "decode_attention")
    launches += 1
    return out
