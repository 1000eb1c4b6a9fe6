"""The serving CLI of the port (``python -m repro_torch.launch.serve``) and
the LM back end it puts behind the cache: the port of ``repro.launch.serve``.

:func:`main` generates the calibrated query stream, finds its topics with
the LDA pipeline (``topic_score`` on the card), compiles a declarative
``ServingSpec`` into a (possibly sharded) :class:`~repro_torch.serving.Cluster`
and serves the test stream closed-loop or open-loop with the LM back end,
printing the reference's lines (``hit_rate=... static_hits=...
topic_hits=... backend_calls=...`` among them) and exiting as it does.  It
takes every flag of the reference and ``--device {cuda,cpu}``: the card by
default, the plain versions on the CPU with ``--device cpu``::

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 50000 --entries 4096
  PYTHONPATH=src python -m repro_torch.launch.serve --shards 4 --routing topic
  PYTHONPATH=src python -m repro_torch.launch.serve --drift-phases 4 --rebalance 8
  PYTHONPATH=src python -m repro_torch.launch.serve --open-loop --shards 4 \
      --fault-shard 2@0.1 --min-availability 1.0
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 20000

The LM's weights are random from a torch generator seeded 0, so the served
values differ from the reference's; which requests hit does not depend on
them, so the hit-rate line is the reference's on the same flags.

On a miss the CLI turns each query id into a stub token window,
``(q * 31 + arange(8)) % vocab``, runs the LM over it, and answers with the
``value_dim`` best-scoring vocabulary ids of the last position, the lower
id first among equal logits (``jax.lax.top_k``'s order).  The reference
computes the whole ``(n, 8, V)`` logits with ``forward`` and keeps the last
position; the port unembeds only the last position, as ``prefill`` does:
the same ids, without the ``(n, 8, 256000)`` f32 logits at full width.
On the card the CLI's back end replays CUDA graphs of that computation,
captured for each power of two of rows up to ``--batch`` (:func:`lm_backend`'s
``graph_max``), where the reference calls its ``jax.jit``: a dense model's
call of n ids replays the set of graphs that covers n rows in the least
measured time, an MoE model's the one graph of the next power of two.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import tempfile
import threading
import time
from typing import Callable

import numpy as np
import torch

from ..configs.registry import get_arch
from ..core.device import resolve_device
from ..core.fast import VecLog, VecStats
from ..core.spec import STRATEGIES, CacheSpec
from ..loadgen import (
    ArrivalSpec,
    FaultInjectSpec,
    SLOSpec,
    run_open_loop,
    stamp_arrivals,
)
from ..models import transformer as tf
from ..models.common import top_k_ids
from ..querylog import DriftConfig, SynthConfig, generate, generate_drifting
from ..serving import (
    BucketSpec,
    Cluster,
    DispatchSpec,
    FreshnessSpec,
    HedgeSpec,
    RebalanceSpec,
    ResilienceSpec,
    ServingSpec,
    tracing,
)
from ..topics import run_pipeline

#: tokens of the stub query text per query id
QUERY_TOKENS = 8


def query_tokens(qids: np.ndarray, vocab_size: int) -> np.ndarray:
    """(n, 8) int64 token windows derived from the query ids."""
    q = np.asarray(qids).astype(np.int64)
    return (q[:, None] * 31 + np.arange(QUERY_TOKENS)[None, :]) % vocab_size


@torch.no_grad()
def model_scores(params: tf.ParamTree, tokens: torch.Tensor, cfg: tf.TransformerConfig,
                 k: int) -> torch.Tensor:
    """(n, k) int32: the top-k vocabulary ids of each window's last position."""
    x = tf.hidden(params, tokens, cfg)
    return top_k_ids(tf._unembed(params, x[:, -1], cfg), k).to(torch.int32)


def _graph_rows(n: int) -> int:
    """The next power of two of ``n``: the largest graph captured for a
    ``graph_max`` of ``n``, and the one graph an MoE model's call of ``n``
    ids replays."""
    return 1 << max(n - 1, 0).bit_length()


def _capture_scores(params: tf.ParamTree, cfg: tf.TransformerConfig, k: int,
                    dev: torch.device, graph_max: int):
    """``{rows: (graph, tokens, ids)}``: ``model_scores`` captured as a CUDA
    graph for every power of two of rows up to ``_graph_rows(graph_max)``,
    each with its own input and output buffers."""
    graphs = {}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    rows = 1
    while rows <= _graph_rows(graph_max):
        tokens = torch.zeros((rows, QUERY_TOKENS), dtype=torch.int64, device=dev)
        with torch.cuda.stream(side):
            # the warm-up call sets up cuBLAS and the allocator off the graph
            model_scores(params, tokens, cfg, k)
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            ids = model_scores(params, tokens, cfg, k)
        graphs[rows] = (graph, tokens, ids)
        rows *= 2
    torch.cuda.current_stream(dev).wait_stream(side)
    return graphs


def _replay_costs(graphs: dict, dev: torch.device) -> dict:
    """``{rows: seconds}``: one replay of each captured graph on the host's
    clock, from its launch to the card's end, so that the replay's fixed
    host cost counts too."""
    costs = {}
    for rows, (graph, _, _) in graphs.items():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize(dev)
        costs[rows] = time.perf_counter() - t0
    return costs


def _replay_plans(cfg: tf.TransformerConfig, costs: dict, n_max: int) -> list:
    """``plans[n]`` for ``n`` from 0 to ``n_max``: the rows of the captured
    graphs a call of ``n`` ids replays, largest first.

    A dense model scores each row's window alone, so a call's rows may be
    split across graphs: its plan is the set of graphs (``costs``' keys,
    each at most once, since a graph has one input and one output buffer)
    whose rows add up to at least ``n`` in the least total ``costs``, a
    0/1 cover found by a dynamic program over the graphs.  In an MoE model
    a call's rows share the experts' capacity, so it replays one graph:
    the next power of two of rows."""
    if cfg.moe is not None:
        return [()] + [(_graph_rows(n),) for n in range(1, n_max + 1)]
    sizes = sorted(costs)
    best = [0.0] + [math.inf] * n_max  # least cost of covering n rows so far
    took = []  # took[i][n]: graph i is in the cover of n after graphs 0..i
    for g in sizes:
        c, t = costs[g], [False] * (n_max + 1)
        for n in range(n_max, 0, -1):
            v = c + best[max(n - g, 0)]
            if v < best[n]:
                best[n], t[n] = v, True
        took.append(t)
    plans = [()]
    for n in range(1, n_max + 1):
        plan, left = [], n
        for g, t in zip(reversed(sizes), reversed(took)):
            if left > 0 and t[left]:
                plan.append(g)
                left = max(left - g, 0)
        plans.append(tuple(plan))
    return plans


def lm_backend(params: tf.ParamTree, cfg: tf.TransformerConfig, value_dim: int = 8,
               device="cuda", graph_max: int = 0) -> Callable[[np.ndarray], np.ndarray]:
    """``backend(qids) -> (n, value_dim) int32`` doc ids, as the CLI's.

    With ``graph_max`` on a CUDA device, ``model_scores`` is captured here
    as a CUDA graph for each power of two of rows up to the next of
    ``graph_max``: a replay is one launch where the eager forward issues
    ~150 small kernels, each at the host's dispatch cost.  It stands where
    the reference jit-compiles ``model_scores``.  A call of 1 to
    ``graph_max`` ids replays the graphs of its plan (``_replay_plans``)
    back to back, its ids staged into them in slices and zero windows in
    the last one's tail, then gathers their answers with one wait on the
    card.  A dense model scores each row's window alone, so the zero rows
    and the split change nothing, and its plan is the cheapest cover of
    the call's rows by the graphs' replay times, measured here once
    (``_replay_costs``).  In an MoE model a call's tokens share the
    experts' capacity (as in the reference, whose batch of windows shares
    it), so it replays the one graph of the next power of two of rows and
    answers as the eager call on the padded rows does.  Larger calls, and
    every call on the CPU, run eagerly.  Calls from several threads take
    turns on the graphs.

    ``backend.counters`` counts, always: ``calls``; ``rows``, the ids asked
    for; ``graph_rows``, the rows computed (the sum of the replayed
    graphs' rows, ``n`` on the eager path); ``eager_calls``; ``replays``,
    the graphs replayed; ``split_calls``, the calls that replayed more
    than one; ``captures``, the graphs captured.  With
    :mod:`..serving.tracing` on, a call records the spans ``backend.call``,
    ``backend.tokens``, ``backend.stage``, a ``backend.replay`` for each
    graph and ``backend.fetch``.  ``backend.plans[n]`` holds the rows of
    the graphs a call of ``n`` ids replays (none without graphs)."""
    dev = resolve_device(device)
    graphs = (_capture_scores(params, cfg, value_dim, dev, graph_max)
              if graph_max > 0 and dev.type == "cuda" else {})
    plans = []
    if graphs:
        costs = _replay_costs(graphs, dev) if cfg.moe is None else {}
        plans = _replay_plans(cfg, costs, graph_max)
    lock = threading.Lock()
    counters = {"calls": 0, "rows": 0, "graph_rows": 0, "eager_calls": 0, "replays": 0,
                "split_calls": 0, "captures": len(graphs)}
    tally = threading.Lock()

    def count(n: int, rows: int, replays: int) -> None:
        with tally:
            counters["calls"] += 1
            counters["rows"] += n
            counters["graph_rows"] += rows
            counters["eager_calls"] += replays == 0
            counters["replays"] += replays
            counters["split_calls"] += replays > 1

    def backend(qids: np.ndarray) -> np.ndarray:
        with tracing.span("backend.call", len(qids)):
            with tracing.span("backend.tokens", len(qids)):
                tokens = torch.from_numpy(query_tokens(qids, cfg.vocab_size))
            n = len(tokens)
            if 0 < n <= graph_max and graphs:
                plan = plans[n]
                count(n, sum(plan), len(plan))
                parts, lo = [], 0
                with lock:
                    with tracing.span("backend.stage", n):
                        for rows in plan:
                            _, inp, ids = graphs[rows]
                            m = min(rows, n - lo)
                            inp[:m].copy_(tokens[lo:lo + m])
                            inp[m:].zero_()
                            parts.append(ids[:m])
                            lo += m
                    for rows in plan:
                        with tracing.span("backend.replay", rows):
                            graphs[rows][0].replay()
                    with tracing.span("backend.fetch", n):
                        out = parts[0] if len(parts) == 1 else torch.cat(parts)
                        return out.cpu().numpy()
            count(n, n, 0)
            out = model_scores(params, tokens.to(dev), cfg, value_dim)
            with tracing.span("backend.fetch", n):
                return out.cpu().numpy()

    backend.counters = counters
    backend.plans = plans
    return backend


def _parse_fault_shard(s: str):
    """``N@T`` -> (shard N, FaultInjectSpec crashing at virtual time T)."""
    try:
        shard, t = s.split("@", 1)
        return int(shard), FaultInjectSpec(crash_at_s=float(t))
    except (ValueError, TypeError):
        raise argparse.ArgumentTypeError(
            f"--fault-shard wants N@T (shard index @ crash time in virtual "
            f"seconds), got {s!r}"
        )


def _parse_ttl_topic(s: str):
    """``TAU:SECONDS`` -> (topic id, TTL seconds)."""
    try:
        tau, sec = s.split(":", 1)
        ttl = float(sec)
        if not ttl > 0:
            raise ValueError("TTL must be > 0")
        return int(tau), ttl
    except (ValueError, TypeError):
        raise argparse.ArgumentTypeError(
            f"--ttl-topic wants TAU:SECONDS (topic id : TTL in virtual "
            f"seconds), got {s!r}"
        )


def _parse_fault_profile(s: str):
    """``N:JSON`` -> (shard N, FaultInjectSpec.from_json(JSON))."""
    try:
        shard, spec = s.split(":", 1)
        return int(shard), FaultInjectSpec.from_json(spec)
    except (ValueError, TypeError, KeyError) as e:
        raise argparse.ArgumentTypeError(
            f"--fault-profile wants N:JSON (shard index : FaultInjectSpec "
            f"JSON), got {s!r} ({e})"
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve the calibrated query stream through the port's "
        "sharded STD-cache cluster on the card (--device cpu: the plain "
        "versions on the CPU).",
    )
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=50_000)
    ap.add_argument("--entries", type=int, default=4096)
    ap.add_argument(
        "--strategy", default="STDv_LRU", choices=("LRU",) + STRATEGIES,
        help="paper strategy compiled to the device cache via CacheSpec",
    )
    ap.add_argument("--f-s", type=float, default=0.5)
    ap.add_argument("--f-t", type=float, default=0.4)
    ap.add_argument("--f-ts", type=float, default=None)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--value-dim", type=int, default=8)
    ap.add_argument(
        "--shards", type=int, default=1,
        help="broker shards the cache's partition/set axis is split across",
    )
    ap.add_argument(
        "--routing", default="hash", choices=("hash", "topic"),
        help="query -> shard routing (topic routing moves whole partitions)",
    )
    ap.add_argument(
        "--pipeline", type=int, default=0, metavar="K",
        help="pipelined async dispatch: submit up to K batches through "
        "serve_async before draining, so per-shard work fuses across "
        "consecutive batches (0 = synchronous scatter-gather). Fused "
        "serves return identical values; cross-batch duplicate hits are "
        "accounted approximately",
    )
    ap.add_argument(
        "--max-fuse", type=int, default=8,
        help="max queued batch segments one shard fuses into a single "
        "broker call when --pipeline is on",
    )
    ap.add_argument(
        "--bucket", default="auto", choices=("auto", "pow2", "off"),
        help="shape-bucketed batch padding: the ragged tail batch and "
        "data-dependent shard slices pad up to a bucket with the reserved "
        "pad key. auto = pow2 on device engines, unpadded on the host "
        "engine; pow2 forces bucketing everywhere",
    )
    ap.add_argument(
        "--one-call", dest="one_call", action="store_true", default=True,
        help="serve via the fused one-dispatch kernel path: probe + commit "
        "+ value gather + deferred-fill apply in a single device call "
        "per batch (device engines only; the default)",
    )
    ap.add_argument(
        "--no-one-call", dest="one_call", action="store_false",
        help="use the legacy 2/3-dispatch serve path (separate fused "
        "probe+commit and fill calls)",
    )
    ap.add_argument(
        "--aot-warmup", action="store_true",
        help="warm every bucket shape at broker construction (the kernels "
        "built and launched once) so no live request waits on a first "
        "launch",
    )
    ap.add_argument(
        "--rebalance", type=int, default=0, metavar="EVERY",
        help="drift-aware topic rebalancing: check every N served batches "
        "(0 = frozen allocation, the paper's setup)",
    )
    ap.add_argument(
        "--rebalance-decay", type=float, default=0.97,
        help="per-batch decay of the tracked topic popularity counts",
    )
    ap.add_argument(
        "--rebalance-threshold", type=float, default=0.0,
        help="min L1 share divergence before a scheduled check migrates",
    )
    ap.add_argument(
        "--open-loop", action="store_true",
        help="serve the test stream open-loop: seeded arrival process, "
        "deadline-driven batch coalescing via the spec's compiled "
        "BatchPolicySpec, per-request latency = queueing + measured "
        "service, SLO verdict",
    )
    ap.add_argument(
        "--rate", type=float, default=0.0,
        help="open-loop mean arrival rate in req/s (0 = 0.7x the batch "
        "policy's provisioned capacity)",
    )
    ap.add_argument(
        "--burst", type=float, default=1.0,
        help="open-loop burstiness: 1 = Poisson arrivals, >1 = on-off "
        "MMPP with this ON-state rate multiplier",
    )
    ap.add_argument(
        "--deadline-ms", type=float, default=0.0,
        help="override the batch policy's coalescing deadline (ms)",
    )
    ap.add_argument(
        "--slo-p99-ms", type=float, default=50.0,
        help="open-loop p99 latency SLO target (ms)",
    )
    ap.add_argument(
        "--arrival-seed", type=int, default=0,
        help="seed of the open-loop arrival process",
    )
    ap.add_argument(
        "--fault-shard", type=_parse_fault_shard, action="append", default=[],
        metavar="N@T",
        help="inject a permanent crash of shard N at virtual time T "
        "seconds (repeatable; open-loop only; enables the resilience "
        "layer so the crash degrades instead of failing)",
    )
    ap.add_argument(
        "--fault-profile", type=_parse_fault_profile, action="append",
        default=[], metavar="N:JSON",
        help="attach a full FaultInjectSpec (JSON) to shard N, e.g. "
        '2:{"error_every": 7} (repeatable; open-loop only)',
    )
    ap.add_argument(
        "--min-availability", type=float, default=0.0,
        help="exit nonzero when availability (fraction of served requests "
        "answered with backend-identical values) drops below this bound",
    )
    ap.add_argument(
        "--ttl-s", type=float, default=0.0,
        help="default result TTL in virtual seconds (0 = entries never "
        "expire).  Closed-loop runs map the synthetic log's time axis to "
        "seconds at one day = 86400s; open-loop runs use the arrival clock",
    )
    ap.add_argument(
        "--ttl-topic", type=_parse_ttl_topic, action="append", default=[],
        metavar="TAU:SECONDS",
        help="per-topic TTL override (repeatable), e.g. --ttl-topic 3:60",
    )
    ap.add_argument(
        "--stale-policy", default="miss",
        choices=("miss", "serve_stale_while_revalidate"),
        help="what an expired hit does: re-fetch before answering (miss) "
        "or answer stale now and revalidate through the deferred fill",
    )
    ap.add_argument(
        "--max-stale-rate", type=float, default=1.0,
        help="exit nonzero when the stale-serve rate (stale_served / "
        "requests) exceeds this bound (serve_stale_while_revalidate only)",
    )
    ap.add_argument(
        "--drift-phases", type=int, default=0,
        help="serve a piecewise-stationary drift stream with this many "
        "popularity phases (oracle topics, no LDA) instead of the "
        "calibrated stationary log",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the cache, the topic pipeline and the LM back end run: "
        "the card (the CUDA kernels; the default) or the CPU (their plain "
        "PyTorch versions)",
    )
    args = ap.parse_args(argv)

    faults = list(args.fault_shard) + list(args.fault_profile)
    if faults and not args.open_loop:
        ap.error("--fault-shard/--fault-profile need --open-loop (fault "
                 "schedules run on the open-loop virtual clock)")
    for shard, _ in faults:
        if not 0 <= shard < args.shards:
            ap.error(f"--fault shard index {shard} out of range for "
                     f"--shards {args.shards}")

    # build the declarative spec up front so configuration errors (e.g. an
    # SDC-section strategy without --f-ts, or a bad shard/routing combo)
    # fail before the expensive log generation; the same spec drives the
    # exact and reuse-distance engines bit-identically
    spec = ServingSpec(
        cache=CacheSpec.from_strategy(
            args.strategy, args.entries, f_s=args.f_s, f_t=args.f_t, f_ts=args.f_ts
        ),
        shards=args.shards,
        routing=args.routing,
        microbatch=args.batch,
        value_dim=args.value_dim,
        # auto (None): device engines bucket pow2, the host engine serves
        # unpadded; the ragged tail batch below is served through bucket
        # padding on the device engine
        bucket={
            "auto": None,
            "pow2": BucketSpec(),
            "off": BucketSpec(mode="none"),
        }[args.bucket],
        hedge=HedgeSpec(deadline_s=2.0),
        fused_one_call=args.one_call,
        aot_warmup=args.aot_warmup,
        dispatch=(
            DispatchSpec(max_fuse=args.max_fuse)
            if args.pipeline > 0
            else None
        ),
        rebalance=(
            RebalanceSpec(
                every=args.rebalance,
                decay=args.rebalance_decay,
                threshold=args.rebalance_threshold,
            )
            if args.rebalance > 0
            else None
        ),
        # fault injection implies the resilience layer: without it any
        # injected fault would simply propagate and kill the run
        resilience=ResilienceSpec(probe_interval_s=0.005) if faults else None,
        freshness=(
            FreshnessSpec(
                ttl_s=args.ttl_s if args.ttl_s > 0 else math.inf,
                topic_ttl_s=dict(args.ttl_topic),
                stale_policy=args.stale_policy,
            )
            if (args.ttl_s > 0 or args.ttl_topic)
            else None
        ),
    )
    print(f"serving spec: {spec.to_json()}")
    dev = resolve_device(args.device)

    if args.drift_phases > 0:
        print(f"generating drift stream ({args.drift_phases} popularity phases) ...")
        dcfg = DriftConfig(
            n_requests=args.requests,
            n_topics=16,
            queries_per_topic=max(args.requests // 64, 64),
            n_notopic_queries=max(args.requests // 40, 64),
            n_phases=args.drift_phases,
            seed=11,
        )
        synth = generate_drifting(dcfg)
        # oracle topics: the drift generator emits no clicked documents, so
        # the LDA pipeline has nothing to train on -- and the scenario under
        # test is the allocation's staleness, not topic discovery
        log = VecLog(
            keys=synth.keys,
            n_train=args.requests // max(args.drift_phases, 1),
            key_topic=synth.true_topic,
        )
        stats = VecStats.from_log(log)
        key_topic = synth.true_topic
    else:
        print("generating calibrated query log + LDA topics ...")
        cfg = SynthConfig(
            n_requests=args.requests,
            n_topics=16,
            n_topical_queries=args.requests // 10,
            n_notopic_queries=args.requests // 20,
            vocab_size=512,
            seed=11,
        )
        synth = generate(cfg, device=dev)
        pipe = run_pipeline(
            synth, train_frac=0.5, lda_iters=15, lda_subsample=5_000, device=dev
        )
        log, stats = pipe.log, pipe.stats
        key_topic = pipe.assignment.key_topic

    arch = get_arch(args.arch)
    mcfg = arch.smoke_config
    # random weights from a seeded generator on the serving device; the
    # back end answers each miss with the LM's top-k ids (lm_backend)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), mcfg)
    backend = lm_backend(params, mcfg, args.value_dim, device=dev, graph_max=args.batch)

    test = log.test_keys
    with Cluster.from_spec(
        spec, stats, [backend], topic_of=lambda q: key_topic[q], value_fn=backend,
        device=dev,
    ) as cluster:
        if args.open_loop:
            policy = spec.compiled_batch_policy()
            if args.deadline_ms > 0:
                policy = dataclasses.replace(
                    policy, deadline_us=args.deadline_ms * 1e3
                )
            rate = args.rate if args.rate > 0 else 0.7 * policy.capacity_rps()
            if args.burst > 1.0:
                arrivals = ArrivalSpec(
                    process="onoff", rate=rate, burst=args.burst,
                    seed=args.arrival_seed,
                )
            else:
                arrivals = ArrivalSpec(
                    process="poisson", rate=rate, seed=args.arrival_seed
                )
            print(
                f"open-loop: {arrivals.process} arrivals at {rate:.0f} req/s "
                f"(provisioned capacity {policy.capacity_rps():.0f} req/s), "
                f"deadline {policy.deadline_us/1e3:.2f}ms, "
                f"max_batch {policy.max_batch}, queue {policy.max_queue} "
                f"({policy.overflow})"
            )
            workload = stamp_arrivals(test, arrivals)
            ckpt_tmp = None
            if faults:
                # a pre-stream checkpoint is what a crashed shard
                # warm-restarts from (checksum-verified)
                ckpt_tmp = tempfile.TemporaryDirectory(prefix="serve_ckpt_")
                cluster.save(ckpt_tmp.name, step=0)
                for shard, fspec in faults:
                    cluster.inject_shard_faults(shard, fspec)
                    print(f"fault injected on shard {shard}: {fspec.to_json()}")
            res = run_open_loop(
                workload, cluster, policy, collect=bool(faults),
                pipeline=args.pipeline or None,
            )
            rep = res.report()
            print(
                f"served {rep.served}/{rep.n} "
                f"(shed {rep.shed}, deferred {rep.deferred}) "
                f"throughput={rep.achieved_rps:.0f} req/s "
                f"(measured service {rep.service_rps:.0f} req/s) "
                f"hit_rate={rep.hit_rate:.4f} pad_overhead={rep.pad_overhead:.2%}"
            )
            print(
                f"latency ms: p50={rep.p50_ms:.3f} p90={rep.p90_ms:.3f} "
                f"p99={rep.p99_ms:.3f} p99.9={rep.p999_ms:.3f} "
                f"(queueing p99={rep.queue_p99_ms:.3f})"
            )
            verdict = SLOSpec(p99_ms=args.slo_p99_ms).evaluate(rep)
            print(verdict.describe())
            fresh_ok = _report_freshness(
                spec, cluster.stats, args.max_stale_rate
            )
            available = True
            if faults:
                served = ~np.isnan(res.queue_s)
                oracle = backend(workload.keys[served])
                availability = (
                    float(np.all(res.values[served] == oracle, axis=1).mean())
                    if served.any()
                    else 0.0
                )
                s = cluster.stats
                recoveries = sum(
                    h.counters.recoveries for h in cluster.shard_health
                )
                spans = [
                    (i, sp)
                    for i, h in enumerate(cluster.shard_health)
                    for sp in h.down_spans()
                ]
                recovery_s = max(
                    (sp[1] - sp[0] for _, sp in spans if sp[1] is not None),
                    default=float("nan"),
                )
                print(
                    f"resilience: availability={availability:.4f} "
                    f"degraded={s.degraded} "
                    f"({s.degraded / max(s.requests, 1):.2%} of requests) "
                    f"retried={s.retried} failed_over={s.failed_over} "
                    f"recoveries={recoveries} recovery_s={recovery_s:.4f}"
                )
                for i, (down_at, up_at) in spans:
                    up = f"{up_at:.4f}" if up_at is not None else "open"
                    print(f"  shard {i} outage: down@{down_at:.4f}s -> {up}")
                available = availability >= args.min_availability
                if not available:
                    print(
                        f"AVAILABILITY FAIL: {availability:.4f} < "
                        f"--min-availability {args.min_availability:.4f}"
                    )
                ckpt_tmp.cleanup()
            return 0 if (verdict.ok and available and fresh_ok) else 1
        # time serving only: construction above preloads the static layer
        # through the model backend and builds the shards' caches, which would
        # otherwise skew the shards=1 vs shards=N comparison
        t0 = time.time()
        # closed-loop freshness clock: the synthetic log's time axis (days
        # for the calibrated log, one "day" per phase for drift) mapped to
        # virtual seconds, advanced to each batch's first arrival
        ts_test = (
            np.asarray(synth.timestamps, np.float64)[log.n_train :] * 86400.0
            if spec.freshness is not None
            else None
        )
        # serve every batch including the ragged tail, so the reported hit
        # rate covers the whole test stream
        starts = list(range(0, len(test), args.batch))
        if args.pipeline > 1:
            # pipelined drive: submit a group before draining so per-shard
            # work fuses across batches; the freshness clock (if any)
            # advances to the group's last batch up front, since queued
            # batches serve at submission time
            for g in range(0, len(starts), args.pipeline):
                grp = starts[g : g + args.pipeline]
                if ts_test is not None:
                    cluster.advance_time(float(ts_test[grp[-1]]))
                futs = [
                    cluster.serve_async(test[lo : lo + args.batch])
                    for lo in grp
                ]
                for f in futs:
                    f.result()
        else:
            for lo in starts:
                if ts_test is not None:
                    cluster.advance_time(float(ts_test[lo]))
                cluster.serve(test[lo : lo + args.batch])
        dt = time.time() - t0
        s = cluster.stats
        assert s.requests == len(test)
        print(
            f"served {s.requests} requests in {dt:.1f}s "
            f"({s.requests/dt:.0f} req/s incl. backend)"
        )
        print(
            f"hit_rate={s.hit_rate:.4f} static_hits={s.static_hits} "
            f"topic_hits={s.topic_hits} backend_calls={s.backend_calls} "
            f"hedged={s.hedged_calls}"
        )
        # pad overhead of the static-shape contract: device-batch slots
        # spent on the reserved pad key (ragged tail + shard slices)
        slot_total = s.requests + s.padded
        print(
            f"bucketing: padded={s.padded} real={s.requests} "
            f"pad_overhead={s.padded / max(slot_total, 1):.2%} of "
            f"{slot_total} device-batch slots; "
            f"device dispatches per entry point: "
            f"{cluster.dispatch_counts or '(host engine: none)'}"
        )
        if args.rebalance > 0:
            print(
                f"rebalances={s.rebalances} migrated_entries={s.migrated} "
                f"(check every {args.rebalance} batches, "
                f"decay={args.rebalance_decay})"
            )
        fresh_ok = _report_freshness(spec, s, args.max_stale_rate)
        if args.shards > 1:
            for i, ss in enumerate(cluster.shard_stats):
                print(
                    f"  shard {i}: requests={ss.requests} "
                    f"hit_rate={ss.hit_rate:.4f}"
                )
    return 0 if fresh_ok else 1


def _report_freshness(spec: ServingSpec, s, max_stale_rate: float) -> bool:
    """Print the freshness stats line; False = the run must exit nonzero
    (stale-serve bound exceeded, or the zero-violation tripwire fired)."""
    if spec.freshness is None:
        return True
    stale_rate = s.stale_served / max(s.requests, 1)
    print(
        f"freshness: expired={s.expired} stale_served={s.stale_served} "
        f"(stale_rate={stale_rate:.4f}) revalidations={s.revalidations} "
        f"violations={s.freshness_violations} invalidations={s.invalidations}"
    )
    ok = True
    if stale_rate > max_stale_rate:
        print(
            f"FRESHNESS FAIL: stale_rate {stale_rate:.4f} > "
            f"--max-stale-rate {max_stale_rate:.4f}"
        )
        ok = False
    if s.freshness_violations:
        print(
            f"FRESHNESS FAIL: {s.freshness_violations} stale values served "
            "without a revalidation in flight"
        )
        ok = False
    return ok


if __name__ == "__main__":
    sys.exit(main())
