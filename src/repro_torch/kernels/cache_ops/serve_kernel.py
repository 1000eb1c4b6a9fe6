"""One-dispatch serve (fill + probe + commit + gather): the CUDA wrapper.

Replaces the Pallas TPU kernel ``repro.kernels.cache_ops.serve_kernel.
serve_fused`` (``src/repro/kernels/cache_ops/serve_kernel.py:203``).  The
TPU kernel recomputes the post-fill value table in every grid step, which
only works because its grid runs in order on one core.  Here the deferred
fill is ``fill_kernel`` and the probe/commit/gather is
``probe_and_commit_kernel<GATHER=true>`` (``repro_torch/csrc/cache_ops.cu``),
two launches on one stream, so every block of the second reads the
post-fill table.  The fill's slots are unique (``fill_winner_slots``), so it
writes the value table in place.  The second launch is the commit kernel's
schedule: one warp per segment, the loads issued in bulk a chunk of 32
requests ahead, only the conflict rounds serial; each chunk's probed value
rows are gathered by the warp (neighbouring lanes on neighbouring words)
while its rounds run.

A tensor on the CPU runs the plain version
(:func:`repro_torch.kernels.cache_ops.ref.serve_fused_plain`); a tensor on
the card launches the kernels or raises.  :data:`launches` counts calls
that launched them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _build
from .kernel import check_commit_args, check_kernel_width, require
from .ref import serve_fused_plain

#: serve launches made through :func:`serve_fused` (CPU calls run the plain
#: version and do not count)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("cache_ops").cache_ops_serve_fused
    fn.argtypes = (
        [_P, _I, _I, _P, _I, _P, _P, _I] + [_P] * 11 + [_I] + [_P] * 7 + [_P]
    )
    fn.restype = _I
    return fn


def serve_fused(
    ks: torch.Tensor,  # (S, 4W) int32 packed words, updated in place
    value: torch.Tensor,  # (S*W, V) int32 flat value table, updated in place
    f_slot: torch.Tensor,  # (F,) int32 unique fill slots (out of range = drop)
    f_vals: torch.Tensor,  # (F, V) int32 fill values
    order: torch.Tensor,  # (B,) int32 sorted position -> arrival position
    leader: torch.Tensor,  # (B,) int32
    seg_len: torch.Tensor,  # (B,) int32
    seg_set: torch.Tensor,  # (B,) int32
    h_hi: torch.Tensor,  # (B,) int32
    h_lo: torch.Tensor,
    admit: torch.Tensor,  # (B,) bool
    static_hit: torch.Tensor,  # (B,) bool
    epochs: torch.Tensor,  # (B,) int32 (uint32 bits)
    min_epoch: torch.Tensor,  # (B,) int32 (uint32 bits)
    clock: torch.Tensor,  # () int32
) -> Tuple[torch.Tensor, ...]:
    """Apply the deferred fill, then probe, commit and gather each
    request's probed value row from the post-fill table.  Returns ``(vals,
    pre_hit, pre_way, pre_stale, pre_epoch, wrote, way)`` in arrival order.
    Launches on the current stream and does not synchronise."""
    global launches
    check_commit_args(
        ks, order, leader, seg_len, seg_set, h_hi, h_lo, admit, static_hit,
        epochs, min_epoch, clock,
    )
    dev = ks.device
    n_sets, w = ks.shape[0], ks.shape[1] // 4
    if value.dim() != 2:
        raise ValueError(f"value must be (S*W, V), got {tuple(value.shape)}")
    v = value.shape[1]
    require(value, "value", torch.int32, (n_sets * w, v), dev)
    f = f_slot.shape[0]
    require(f_slot, "f_slot", torch.int32, (f,), dev)
    require(f_vals, "f_vals", torch.int32, (f, v), dev)
    if dev.type == "cpu":
        return serve_fused_plain(
            ks, value, f_slot, f_vals, order, leader, seg_len, seg_set, h_hi,
            h_lo, admit, static_hit, epochs, min_epoch, clock,
        )
    check_kernel_width(ks)
    b = h_hi.shape[0]
    empty = functools.partial(torch.empty, b, device=dev)
    outs = (
        torch.empty((b, v), dtype=torch.int32, device=dev),
        empty(dtype=torch.bool), empty(dtype=torch.int32),
        empty(dtype=torch.bool), empty(dtype=torch.int32),
        empty(dtype=torch.bool), empty(dtype=torch.int32),
    )
    if b == 0 and f == 0:
        return outs
    with torch.cuda.device(dev):
        err = _entry()(
            ks.data_ptr(), n_sets, w, value.data_ptr(), v,
            f_slot.data_ptr(), f_vals.data_ptr(), f,
            order.data_ptr(), leader.data_ptr(), seg_len.data_ptr(),
            seg_set.data_ptr(), h_hi.data_ptr(), h_lo.data_ptr(),
            admit.data_ptr(), static_hit.data_ptr(), epochs.data_ptr(),
            min_epoch.data_ptr(), clock.data_ptr(), b,
            *(t.data_ptr() for t in outs),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "serve_fused")
    launches += 1
    return outs
