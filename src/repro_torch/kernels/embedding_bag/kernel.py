"""EmbeddingBag over ``(B, L)`` bags: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``repro.kernels.embedding_bag.kernel.
embedding_bag`` (``src/repro/kernels/embedding_bag/kernel.py:37``) and the
op's zero-row padding around it with ``embedding_bag_kernel`` in
``repro_torch/csrc/embedding_bag.cu``: one warp per bag, pads skipped, no
sort and no copy of the table.  The source says what bounds it on an H100
(bytes) and what the design does about it.

A tensor on the CPU (or on ``meta``, the dry-run's shapes) runs the plain version
(:func:`repro_torch.kernels.embedding_bag.ref.embedding_bag_plain`); a
tensor on the card launches the kernel or raises.  :data:`launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import MODES, embedding_bag_plain

#: kernel launches made through :func:`embedding_bag` (CPU calls run the
#: plain version and do not count)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_DTYPES = (torch.int32, torch.int64)
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("embedding_bag").embedding_bag_launch
    fn.argtypes = [_P, ctypes.c_longlong, _I, _I, _P, _I, _I, _I, _I, _P, _P]
    fn.restype = _I
    return fn


def check_args(table: torch.Tensor, bags: torch.Tensor, mode: str) -> None:
    """Raise on what the kernel does not take."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if table.dim() != 2 or bags.dim() != 2:
        raise ValueError(
            f"table must be (V, D) and bags (B, L), got {tuple(table.shape)} and "
            f"{tuple(bags.shape)}"
        )
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if bags.dtype not in _INDEX_DTYPES:
        raise TypeError(f"bags must be int32 or int64, got {bags.dtype}")
    if bags.device != table.device:
        raise ValueError(f"bags are on {bags.device}, the table on {table.device}")
    if not table.is_contiguous() or not bags.is_contiguous():
        raise ValueError("table and bags must be contiguous")
    if table.shape[0] < 1 or table.shape[1] < 1:
        raise ValueError(f"the table must have rows and columns, got {tuple(table.shape)}")
    if bags.shape[0] >= 2**31 or bags.shape[1] >= 2**31 or table.shape[1] >= 2**31:
        raise ValueError("B, L and D must each be below 2**31")


def embedding_bag(table: torch.Tensor, bags: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """``(B, D)`` in the table's dtype: per bag, the sum (or mean) of the
    rows its non-negative ids name, as :func:`embedding_bag_plain` computes
    it, bit for bit.  Launches on the current stream and does not
    synchronise."""
    global launches
    check_args(table, bags, mode)
    dev = table.device
    if dev.type in ("cpu", "meta"):  # meta: shapes only (the dry-run)
        return embedding_bag_plain(table, bags, mode)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    (v, d), (b, l) = table.shape, bags.shape
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    if b == 0:
        return out
    with torch.cuda.device(dev):
        err = _entry()(
            table.data_ptr(), v, d, _DTYPES[table.dtype], bags.data_ptr(),
            bags.element_size(), b, l, int(mode == "mean"), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "embedding_bag")
    launches += 1
    return out
