"""Query logs: the port's copy of the reference's synthetic log."""
from .synth import NO_TOPIC, SynthConfig, SynthLog, generate, generate_stream

__all__ = ["NO_TOPIC", "SynthConfig", "SynthLog", "generate", "generate_stream"]
