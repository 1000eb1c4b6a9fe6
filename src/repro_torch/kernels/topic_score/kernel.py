"""LDA topic scores with a fused argmax and confidence: the CUDA kernel's
wrapper.

Replaces the Pallas TPU kernel ``repro.kernels.topic_score.kernel.
topic_score`` (``src/repro/kernels/topic_score/kernel.py:51``) with
``topic_score_kernel`` in ``repro_torch/csrc/topic_score.cu``: one warp per
document row streams the counts once and takes the FMAs of its non-zero
counts only, in ascending word order, with the argmax and softmax epilogue
in registers.  The source says what bounds it on an H100 (bytes: the dense
counts read once) and what the design does about it.

A tensor on the CPU runs the plain version
(:func:`repro_torch.kernels.topic_score.ref.topic_score_plain`); a tensor
on the card launches the kernel or raises.  :data:`launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _build
from ..cache_ops.kernel import require
from .ref import topic_score_plain

#: kernel launches made through :func:`topic_score` (CPU calls run the plain
#: version and do not count)
launches = 0

#: most accumulators a lane holds, as ``kMaxAcc`` in the CUDA source: one
#: pass over a row covers 32 * MAX_ACC topics
MAX_ACC = 16

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("topic_score").topic_score_launch
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]
    fn.restype = _I
    return fn


def acc_count(k: int) -> int:
    """Accumulators a lane holds for ``k`` topics (the kernel's template
    parameter): one per 32 topics, at most :data:`MAX_ACC`; a wider ``k``
    is swept in passes of ``32 * acc_count(k)`` topics."""
    return min(-(-k // 32), MAX_ACC)


def vec_width(ptr: int, v: int) -> int:
    """Words a lane loads at once: 4 (16 bytes) when every row of the counts
    starts 16-byte aligned, else 1."""
    return 4 if ptr % 16 == 0 and v % 4 == 0 else 1


def topic_score(
    counts: torch.Tensor,  # (B, V) f32, contiguous
    log_phi_t: torch.Tensor,  # (V, K) f32, contiguous, K >= 1
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(scores (B, K) f32, top (B,) int32, conf (B,) f32)`` of ``counts @
    log_phi_t``: ``top`` is the first maximal topic and ``conf`` its softmax
    probability.  Launches on the current stream and does not synchronise.

    ``log_phi_t`` must be finite: the kernel skips zero counts, so a zero
    count times a non-finite entry (NaN in the dense product) is not
    formed.  The pipeline's ``log_phi`` is ``log(max(phi, 1e-12))``."""
    global launches
    if counts.dim() != 2 or log_phi_t.dim() != 2:
        raise ValueError(
            f"counts and log_phi_t must be 2-D, got {tuple(counts.shape)} and "
            f"{tuple(log_phi_t.shape)}"
        )
    b, v = counts.shape
    k = log_phi_t.shape[1]
    if k < 1:
        raise ValueError("log_phi_t needs at least one topic column")
    dev = counts.device
    require(counts, "counts", torch.float32, (b, v), dev)
    require(log_phi_t, "log_phi_t", torch.float32, (v, k), dev)
    if dev.type == "cpu":
        return topic_score_plain(counts, log_phi_t)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    top = torch.empty(b, dtype=torch.int32, device=dev)
    conf = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return scores, top, conf
    with torch.cuda.device(dev):
        err = _entry()(
            counts.data_ptr(), log_phi_t.data_ptr(), b, v, k,
            acc_count(k), vec_width(counts.data_ptr(), v),
            scores.data_ptr(), top.data_ptr(), conf.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "topic_score")
    launches += 1
    return scores, top, conf
