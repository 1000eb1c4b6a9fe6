"""Query logs: the port's copy of the reference's synthetic logs (the
calibrated log, the drift stream and the invalidation streams) and of its
parsers for the real AOL and MSN logs."""
from .parse import ParsedLog, normalize_query, parse_aol, parse_msn, time_split
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
    "ParsedLog",
    "SynthConfig",
    "SynthLog",
    "generate",
    "generate_drifting",
    "generate_invalidations",
    "generate_stream",
    "normalize_query",
    "parse_aol",
    "parse_msn",
    "time_split",
]
