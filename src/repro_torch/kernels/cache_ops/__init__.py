"""The STD cache's serving ops: packed-state helpers, the segment plan, the
vectorised rounds loop, and the two kernels of the serving step
(probe/commit and one-dispatch serve), each beside its plain PyTorch
version in :mod:`.ref`; the reference's sequential numpy oracles in
:mod:`.oracle`."""
from .ops import (
    PACKED_WORDS,
    PAD_HI,
    PAD_LO,
    fill_winner_slots,
    pack_words,
    plan_segments,
    probe_and_commit_op,
    resolve_conflicts,
    serve_fused_op,
    unpack_epoch,
    unpack_words,
)
from .oracle import probe_and_commit_ref, serve_fused_ref

__all__ = [
    "PACKED_WORDS",
    "PAD_HI",
    "PAD_LO",
    "fill_winner_slots",
    "pack_words",
    "plan_segments",
    "probe_and_commit_op",
    "probe_and_commit_ref",
    "resolve_conflicts",
    "serve_fused_op",
    "serve_fused_ref",
    "unpack_epoch",
    "unpack_words",
]
