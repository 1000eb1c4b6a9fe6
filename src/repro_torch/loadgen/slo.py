"""Tail-latency SLOs: declarative targets judged against a LoadReport
(port of ``repro.loadgen.slo``).

A production cache is judged on its latency *distribution* under load,
not its mean: an ``SLOSpec`` declares per-percentile targets (ms) plus a
shed-rate bound, and :meth:`SLOSpec.evaluate` checks a harness
:class:`~repro_torch.loadgen.harness.LoadReport` against them, returning every
violation with the observed vs. target value.  The serving CLI's
open-loop mode prints this verdict and exits non-zero on a violation.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .harness import LoadReport

#: report fields an SLOSpec can bound, in severity order
_PERCENTILE_FIELDS = ("p50_ms", "p90_ms", "p99_ms", "p999_ms")


@dataclass(frozen=True)
class SLOSpec:
    """Latency/shedding service-level objectives (JSON round-trippable).

    ``None`` percentile targets are unconstrained; ``max_shed_rate``
    always applies (0 = every accepted request must be served).
    """

    p50_ms: Optional[float] = None
    p90_ms: Optional[float] = None
    p99_ms: Optional[float] = None
    p999_ms: Optional[float] = None
    max_shed_rate: float = 0.0

    def __post_init__(self):
        for f in _PERCENTILE_FIELDS:
            v = getattr(self, f)
            if v is not None:
                object.__setattr__(self, f, float(v))
                if float(v) <= 0:
                    raise ValueError(f"{f} target must be > 0, got {v}")
        object.__setattr__(self, "max_shed_rate", float(self.max_shed_rate))
        if not 0.0 <= self.max_shed_rate <= 1.0:
            raise ValueError(
                f"max_shed_rate must be in [0, 1], got {self.max_shed_rate}"
            )

    # -- serialization ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "SLOSpec":
        return cls(**json.loads(s))

    # -- evaluation ------------------------------------------------------

    def evaluate(self, report: LoadReport) -> "SLOResult":
        """Every violated objective as ``name -> (observed, target)``."""
        violations: Dict[str, Tuple[float, float]] = {}
        for f in _PERCENTILE_FIELDS:
            target = getattr(self, f)
            if target is None:
                continue
            observed = float(getattr(report, f))
            # NaN (nothing served) never passes a latency objective
            if not observed <= target:
                violations[f] = (observed, target)
        if report.shed_rate > self.max_shed_rate:
            violations["shed_rate"] = (report.shed_rate, self.max_shed_rate)
        return SLOResult(ok=not violations, violations=violations)


@dataclass
class SLOResult:
    ok: bool
    violations: Dict[str, Tuple[float, float]] = field(default_factory=dict)

    def describe(self) -> str:
        if self.ok:
            return "SLO: ok"
        parts = [
            f"{k}={obs:.3f} > {tgt:.3f}" for k, (obs, tgt) in self.violations.items()
        ]
        return "SLO VIOLATED: " + ", ".join(parts)


__all__ = ["SLOResult", "SLOSpec"]
