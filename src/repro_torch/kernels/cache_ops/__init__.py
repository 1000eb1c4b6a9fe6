"""The STD cache's serving ops: packed-state helpers, the segment plan, and
the two kernels of the serving step (probe/commit and one-dispatch serve),
each beside its plain PyTorch version in :mod:`.ref`."""
from .ops import (
    PACKED_WORDS,
    PAD_HI,
    PAD_LO,
    fill_winner_slots,
    pack_words,
    plan_segments,
    probe_and_commit_op,
    serve_fused_op,
    unpack_epoch,
    unpack_words,
)

__all__ = [
    "PACKED_WORDS",
    "PAD_HI",
    "PAD_LO",
    "fill_winner_slots",
    "pack_words",
    "plan_segments",
    "probe_and_commit_op",
    "serve_fused_op",
    "unpack_epoch",
    "unpack_words",
]
