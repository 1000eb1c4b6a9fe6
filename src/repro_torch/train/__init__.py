"""Training substrate: optimizer, checkpointing, data pipeline (the port of
``repro.train``, every name of its ``__all__``)."""
from .checkpoint import all_steps, latest_step, restore, save
from .data import ShardInfo, SyntheticLM
from .optim import (
    AdafactorConfig,
    AdamWConfig,
    FactoredState,
    OptState,
    adafactor_updates,
    apply_updates,
    init_adafactor_state,
    init_opt_state,
)

__all__ = [
    "AdafactorConfig",
    "AdamWConfig",
    "FactoredState",
    "OptState",
    "adafactor_updates",
    "init_adafactor_state",
    "ShardInfo",
    "SyntheticLM",
    "all_steps",
    "apply_updates",
    "init_opt_state",
    "latest_step",
    "restore",
    "save",
]
