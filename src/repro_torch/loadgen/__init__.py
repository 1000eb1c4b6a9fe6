"""Open-loop load generation: arrival processes, virtual-clock harness,
tail-latency SLOs (port of ``repro.loadgen``).

The loadgen subsystem turns the repo's synthetic query streams into
open-loop workloads (``arrivals``), drives them through a real
``Broker``/``Cluster`` of the port with deadline-driven, bucket-aware batch
coalescing and bounded-queue backpressure (``harness``), and judges the
resulting latency distribution against declarative SLO targets
(``slo``).  ``inject`` provides deterministic latency *and fault*
injection -- seeded schedules of errors, timeouts, permanent shard
crashes, and checkpoint corruption -- for exercising the hedged-dispatch
and resilience paths.  ``arrivals``, ``inject`` and ``slo`` are numpy
only; ``harness`` drives :mod:`repro_torch.serving`.
"""
from .arrivals import ArrivalSpec, Workload, merge_workloads, stamp_arrivals
from .harness import (
    LoadPlan,
    LoadReport,
    LoadResult,
    PlannedBatch,
    plan_batches,
    run_open_loop,
    snap_down,
    warmup_server,
)
from .inject import (
    FaultInjectSpec,
    FaultInjector,
    InjectedCrash,
    InjectedError,
    InjectedFault,
    InjectedTimeout,
    LatencyInjectSpec,
    corrupt_checkpoint,
    inject_faults,
    inject_latency,
)
from .slo import SLOResult, SLOSpec

__all__ = [
    "ArrivalSpec",
    "FaultInjectSpec",
    "FaultInjector",
    "InjectedCrash",
    "InjectedError",
    "InjectedFault",
    "InjectedTimeout",
    "LatencyInjectSpec",
    "LoadPlan",
    "LoadReport",
    "LoadResult",
    "PlannedBatch",
    "SLOResult",
    "SLOSpec",
    "Workload",
    "corrupt_checkpoint",
    "inject_faults",
    "inject_latency",
    "merge_workloads",
    "plan_batches",
    "run_open_loop",
    "snap_down",
    "stamp_arrivals",
    "warmup_server",
]
