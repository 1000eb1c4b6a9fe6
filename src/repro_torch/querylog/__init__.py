"""Query logs: the port's copy of the reference's synthetic logs (the
calibrated log, the drift stream and the invalidation streams)."""
from .synth import (
    INVAL_KEY,
    INVAL_TOPIC,
    NO_TOPIC,
    DriftConfig,
    InvalidationConfig,
    InvalidationStream,
    SynthConfig,
    SynthLog,
    generate,
    generate_drifting,
    generate_invalidations,
    generate_stream,
)

__all__ = [
    "DriftConfig",
    "INVAL_KEY",
    "INVAL_TOPIC",
    "InvalidationConfig",
    "InvalidationStream",
    "NO_TOPIC",
    "SynthConfig",
    "SynthLog",
    "generate",
    "generate_drifting",
    "generate_invalidations",
    "generate_stream",
]
