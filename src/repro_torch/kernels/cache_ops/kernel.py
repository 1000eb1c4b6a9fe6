"""Probe + conflict-aware batch commit: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``repro.kernels.cache_ops.kernel.
probe_and_commit`` (``src/repro/kernels/cache_ops/kernel.py:215``) with
``probe_and_commit_kernel`` in ``repro_torch/csrc/cache_ops.cu``: one warp
per segment (a run of same-set requests in arrival order) loads the
segment's requests 32 at a time, a chunk ahead, probes them against the
set's pristine row in parallel, and runs only the conflict rounds one after
the other: each request's operands are shuffled from the lane that loaded
it, and the evolving row lives in the warp's registers, way k on lane k, so
a round is a few warp votes.  The source says what bounds it on an H100
(bytes) and what sets its time (the serial chain through one set's row).

A tensor on the CPU runs the plain version
(:func:`repro_torch.kernels.cache_ops.ref.probe_and_commit_plain`); a
tensor on the card launches the kernel or raises.  :data:`launches`
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from .. import _build
from .ref import probe_and_commit_plain

#: kernel launches made through :func:`probe_and_commit` (CPU calls run the
#: plain version and do not count)
launches = 0

#: the widest set the kernels are instantiated for (csrc/cache_ops.cu)
MAX_WAYS = 32

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("cache_ops").cache_ops_probe_and_commit
    fn.argtypes = [_P, _I, _I] + [_P] * 11 + [_I] + [_P] * 6 + [_P]
    fn.restype = _I
    return fn


def require(t, name: str, dtype: torch.dtype, shape: Sequence[int], device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` -- what the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_commit_args(
    ks, order, leader, seg_len, seg_set, h_hi, h_lo, admit, static_hit,
    epochs, min_epoch, clock,
) -> None:
    """Validate the arguments both cache-op kernels share."""
    dev = ks.device
    if ks.dim() != 2 or ks.shape[1] % 4 or ks.shape[0] < 1:
        raise ValueError(f"ks must be (S >= 1, 4W), got {tuple(ks.shape)}")
    require(ks, "ks", torch.int32, ks.shape, dev)
    b = h_hi.shape[0]
    for name, t in (("order", order), ("leader", leader), ("seg_len", seg_len),
                    ("seg_set", seg_set), ("h_hi", h_hi), ("h_lo", h_lo),
                    ("epochs", epochs), ("min_epoch", min_epoch)):
        require(t, name, torch.int32, (b,), dev)
    require(admit, "admit", torch.bool, (b,), dev)
    require(static_hit, "static_hit", torch.bool, (b,), dev)
    require(clock, "clock", torch.int32, (), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def check_kernel_width(ks: torch.Tensor) -> None:
    """The kernels are instantiated for W <= 32 ways."""
    if ks.shape[1] // 4 > MAX_WAYS:
        raise ValueError(f"the CUDA kernels take W <= {MAX_WAYS} ways, got {ks.shape[1] // 4}")


def probe_and_commit(
    ks: torch.Tensor,  # (S, 4W) int32 packed words, updated in place
    order: torch.Tensor,  # (B,) int32 sorted position -> arrival position
    leader: torch.Tensor,  # (B,) int32 first sorted position per segment
    seg_len: torch.Tensor,  # (B,) int32 requests per segment (0 = none)
    seg_set: torch.Tensor,  # (B,) int32 set of each segment
    h_hi: torch.Tensor,  # (B,) int32 request hash words, arrival order
    h_lo: torch.Tensor,
    admit: torch.Tensor,  # (B,) bool
    static_hit: torch.Tensor,  # (B,) bool: static-layer hits never write
    epochs: torch.Tensor,  # (B,) int32 write epochs (uint32 bits)
    min_epoch: torch.Tensor,  # (B,) int32 freshness floors (uint32 bits)
    clock: torch.Tensor,  # () int32
) -> Tuple[torch.Tensor, ...]:
    """Probe every request against the pristine rows and commit the batch
    in arrival order, per set; ``ks`` is updated in place (the caller owns
    the state).  Returns ``(pre_hit, pre_way, pre_stale, pre_epoch, wrote,
    way)`` in arrival order.  Launches on the current stream and does not
    synchronise."""
    global launches
    check_commit_args(
        ks, order, leader, seg_len, seg_set, h_hi, h_lo, admit, static_hit,
        epochs, min_epoch, clock,
    )
    if ks.device.type == "cpu":
        return probe_and_commit_plain(
            ks, order, leader, seg_len, seg_set, h_hi, h_lo, admit, static_hit,
            epochs, min_epoch, clock,
        )
    check_kernel_width(ks)
    b = h_hi.shape[0]
    empty = functools.partial(torch.empty, b, device=ks.device)
    outs = (
        empty(dtype=torch.bool), empty(dtype=torch.int32),
        empty(dtype=torch.bool), empty(dtype=torch.int32),
        empty(dtype=torch.bool), empty(dtype=torch.int32),
    )
    if b == 0:
        return outs
    with torch.cuda.device(ks.device):
        err = _entry()(
            ks.data_ptr(), ks.shape[0], ks.shape[1] // 4,
            order.data_ptr(), leader.data_ptr(), seg_len.data_ptr(),
            seg_set.data_ptr(), h_hi.data_ptr(), h_lo.data_ptr(),
            admit.data_ptr(), static_hit.data_ptr(), epochs.data_ptr(),
            min_epoch.data_ptr(), clock.data_ptr(), b,
            *(t.data_ptr() for t in outs),
            torch.cuda.current_stream(ks.device).cuda_stream,
        )
    _build.check(err, "probe_and_commit")
    launches += 1
    return outs
