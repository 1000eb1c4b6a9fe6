"""Serving specs of the port.  Only :class:`BucketSpec` is ported so far
(``repro.serving.spec.BucketSpec``); ``ServingSpec`` and the rest come in a
later slice (ROADMAP.md, Queue 1 item 4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

_BUCKET_MODES = ("none", "pow2", "explicit")


@dataclass(frozen=True)
class BucketSpec:
    """Shape buckets for data-dependent batch lengths -- the static-shape
    serving contract.

    A ``BucketSpec`` rounds every batch length up to a *bucket* and pads
    the tail with the reserved never-resident pad key
    (:data:`repro_torch.core.spec.PAD_KEY`), so the serving path sees
    O(#buckets) batch shapes, not one per distinct length, and padded
    serving stays
    request-for-request identical to unpadded serving on the real
    requests (the pad key never hits, is never admitted, and never
    displaces a resident entry -- property-tested in every engine).

    ``mode``     -- ``"pow2"`` (next power of two >= the batch length),
                    ``"explicit"`` (smallest declared size that fits;
                    larger batches fall back to powers of two so the
                    compile count stays bounded), or ``"none"``
                    (explicitly disable padding; a broker given no
                    ``BucketSpec`` buckets in pow2).
    ``sizes``    -- the explicit bucket sizes (ascending), required for
                    ``mode="explicit"``.
    ``min_size`` -- the smallest bucket (pow2 mode); tiny trailing
                    batches all land in one bucket.
    """

    mode: str = "pow2"  # "none" | "pow2" | "explicit"
    sizes: Tuple[int, ...] = ()
    min_size: int = 8

    def __post_init__(self):
        object.__setattr__(self, "min_size", int(self.min_size))
        object.__setattr__(
            self, "sizes", tuple(sorted(int(s) for s in self.sizes))
        )
        if self.mode not in _BUCKET_MODES:
            raise ValueError(f"bucket mode must be one of {_BUCKET_MODES}, got {self.mode!r}")
        if self.min_size < 1:
            raise ValueError(f"bucket min_size must be >= 1, got {self.min_size}")
        if self.mode == "explicit" and not self.sizes:
            raise ValueError('bucket mode "explicit" requires sizes')
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"bucket sizes must be >= 1, got {self.sizes}")

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    def padded_len(self, b: int) -> int:
        """The bucket a batch of ``b`` requests pads up to (``b`` itself
        when disabled or empty)."""
        if b <= 0 or not self.enabled:
            return max(int(b), 0)
        if self.mode == "explicit":
            for s in self.sizes:
                if s >= b:
                    return s
            # beyond the largest declared bucket: powers of two keep the
            # compile count logarithmic instead of one trace per length
        return 1 << (max(int(b), self.min_size) - 1).bit_length()
