#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. card: name and power limit, toolkit and torch versions;
2. build: compiles ``src/repro_torch/csrc/*.cu`` for sm_90a and prints
   ``ptxas -v``'s registers, shared memory and spills per kernel;
3. stream: the paper-calibrated query log (``SynthConfig``, the port's
   copy of ``repro.querylog.synth``) with its counts scaled by ``SCALE``:
   96 topics, 62% of requests topical, per-topic cores and Zipf(1.05)
   tails, a no-topic pool with 35% fresh singletons, daily topic bursts.
   The training prefix picks the 2**21 static keys and sizes the topic
   partitions; the requests after it are served.  The served topical
   share must match the config's;
4. warm: a 2**22-entry STD cache (f_s = 0.5, f_t = 0.4, W = 8, V = 8)
   behind a ``Broker`` on the card replays the training prefix's last
   ``N_WARM`` batches, so the LRU layers start warm (the paper's
   train-warm / test-measure protocol);
5. serve: the served requests in batches of 4096 through the one-call
   path; every served value must equal the backend's, with one
   ``one_call`` dispatch and one serve-kernel launch per batch, and the
   set-associative layers must answer at least ``MIN_SET_ASSOC_SHARE`` of
   the requests.  Then the same batches through ``fused_one_call=False``
   (the probe/commit kernel) from the same warm state: hit masks and values
   must be identical.  A profiled window splits a batch's time into
   device and host work;
6. cpu: the first batches on a ``Broker(device="cpu")`` (the plain
   versions) from the same warm state; hit masks, values and the flushed
   state words must be identical to the card's;
7. kernels: each kernel against its plain PyTorch version on the card,
   tolerance 0 (integer state), on the serving path's own batch (the
   inputs of the second served batch's launch, captured), on a batch spread
   uniformly over the sets, and on an edge-case batch (deep same-set
   conflicts, duplicates, pad keys, epochs at and above 2**31).  Times each
   kernel on the serving batch with CUDA events (state restored and L2
   flushed before every launch) beside its byte bound and the plain
   version's time.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
SEED = 0
B = 4096
WAYS = 8
VDIM = 8
ENTRIES = 1 << 22
#: SynthConfig's request and query counts times SCALE (as the benchmarks'
#: ``scale`` does): 200M requests, so the 2**22-entry cache is ~11% of the
#: training prefix's distinct queries, the top of the paper's 0.7%-11%
#: range of cache sizes (benchmarks/common.py)
SCALE = 100
N_WARM = 4096
N_BATCHES = 64
N_CPU_BATCHES = 8
N_PROFILE = 9
#: the served topical share may differ from the config's by this much
#: (binomial sd over the served requests is ~0.0009)
TOPICAL_TOL = 0.01
#: share of served requests the topic and dynamic layers must answer: the
#: stream must exercise them (a static-lookup-only stream answers ~0.0003)
MIN_SET_ASSOC_SHARE = 0.005


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# -- phases 3-6: the stream and serving through the broker ---------------------


def make_stream(seed: int):
    """``(cfg, train, serve, true_topic)``: the scaled SynthConfig stream
    split into its training prefix and the served requests after it."""
    from repro_torch.querylog import SynthConfig, generate_stream

    base = SynthConfig()
    cfg = SynthConfig(
        n_requests=base.n_requests * SCALE,
        n_topical_queries=base.n_topical_queries * SCALE,
        n_notopic_queries=base.n_notopic_queries * SCALE,
        seed=seed,
    )
    keys, true_topic = generate_stream(cfg)
    n_serve = (N_BATCHES + N_PROFILE) * B
    return cfg, keys[:-n_serve], keys[-n_serve:], true_topic


def backend(q: np.ndarray) -> np.ndarray:
    """Deterministic stand-in for the search back end: (n, V) doc ids."""
    q = np.asarray(q, np.int64)
    return ((q[:, None] * 2654435761 + np.arange(VDIM)[None, :] * 40503) % 1000003).astype(np.int32)


def plan_cache(train, true_topic):
    """The cache's layout from the training prefix: topic partitions sized
    by distinct training queries per topic, the most frequent training
    queries static.  Returns ``(cfg, static ids, distinct training ids)``."""
    from repro_torch.serving import DeviceCacheConfig

    uniq, counts = np.unique(train, return_counts=True)
    topics = true_topic[uniq]
    tt, tc = np.unique(topics[topics >= 0], return_counts=True)
    cfg = DeviceCacheConfig.build(
        ENTRIES, f_s=0.5, f_t=0.4, topic_distinct=dict(zip(tt.tolist(), tc.tolist())),
        ways=WAYS, value_dim=VDIM,
    )
    static = uniq[np.argsort(-counts, kind="stable")[: cfg.static_entries]]
    return cfg, static, len(uniq)


def make_cache(device, cfg, static):
    from repro_torch.serving import STDDeviceCache, splitmix64

    return STDDeviceCache(cfg, static_hashes=splitmix64(static),
                          static_values=backend(static), device=device)


def make_broker(cache, true_topic, device, **kw):
    from repro_torch.serving import Broker, BucketSpec

    topic_of = lambda q: true_topic[np.asarray(q, np.int64)]  # noqa: E731
    return Broker(cache, [backend], topic_of, microbatch=B, bucket=BucketSpec(),
                  device=device, **kw)


def serve_stream(broker, batches):
    """Serve ``batches`` in order; returns hit masks, values and each
    ``serve`` call's host-clock seconds (the call returns after its device
    work: the reply is copied back to the host)."""
    hits, vals, secs = [], [], []
    for q in batches:
        t0 = time.perf_counter()
        v, h = broker.serve(q)
        secs.append(time.perf_counter() - t0)
        check(np.array_equal(v, backend(q)), "a served value differs from the backend's")
        hits.append(h)
        vals.append(v)
    return hits, vals, secs


def layer_line(stats) -> str:
    n = max(stats.requests, 1)
    return (f"hit rate {stats.hit_rate:.6f} (static {stats.static_hits / n:.6f}, "
            f"set-associative {stats.topic_hits / n:.6f} of requests)")


def phase_warm(broker, train):
    """Replay the training prefix's last ``N_WARM`` batches; returns the
    flushed warm state as numpy words."""
    from repro_torch.serving import BrokerStats, state_to_numpy

    tail = train[len(train) - N_WARM * B :]
    t0 = time.perf_counter()
    for i in range(N_WARM):
        q = tail[i * B : (i + 1) * B]
        v, _ = broker.serve(q)
        check(np.array_equal(v, backend(q)), "a warm-up value differs from the backend's")
    broker.flush()
    torch.cuda.synchronize()
    print(f"warm: {N_WARM} training batches x {B} on the card in "
          f"{time.perf_counter() - t0:.3f} s, {layer_line(broker.stats)}")
    broker.stats = BrokerStats()
    return state_to_numpy(broker.state)


class Capture:
    """Within the block, clones of the inputs of one kernel-wrapper call on
    the serving path (the ``index``-th, from 0), taken before the call: the
    kernels update ``ks`` and ``value`` in place."""

    def __init__(self, attr: str, index: int):
        from repro_torch.kernels.cache_ops import ops

        self.ops, self.attr, self.index = ops, attr, index
        self.calls, self.args = 0, None

    def __enter__(self):
        orig = self.orig = getattr(self.ops, self.attr)

        def shim(*args):
            if self.calls == self.index:
                self.args = tuple(a.clone() for a in args)
            self.calls += 1
            return orig(*args)

        setattr(self.ops, self.attr, shim)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.attr, self.orig)


def phase_serve(device, cache, true_topic, first, warm, serve):
    from repro_torch.kernels.cache_ops import kernel as pac
    from repro_torch.kernels.cache_ops import serve_kernel as srv
    from repro_torch.serving import state_from_numpy, state_to_numpy

    batches = [serve[i : i + B] for i in range(0, N_BATCHES * B, B)]
    extra = [serve[i : i + B] for i in range(N_BATCHES * B, len(serve), B)]
    out = {}
    for name, one_call in (("one_call", True), ("legacy", False)):
        if one_call:
            broker = first
        else:
            broker = make_broker(cache, true_topic, device, fused_one_call=False)
            broker.state = state_from_numpy(warm, device)
        broker.warmup([B])
        wrapper = "_serve_fused" if one_call else "_probe_and_commit"
        broker.dispatch_counts.clear()
        srv.launches = 0
        pac.launches = 0
        torch.cuda.synchronize()
        with Capture(wrapper, 1) as cap:
            hits, vals, secs = serve_stream(broker, batches[:N_CPU_BATCHES])
        snap = None
        if one_call:  # the card's state for the CPU comparison
            broker.flush()
            snap = state_to_numpy(broker.state)
        h2, v2, s2 = serve_stream(broker, batches[N_CPU_BATCHES:])
        launches = {"serve_fused": srv.launches, "probe_and_commit": pac.launches}
        counts = dict(broker.dispatch_counts)
        secs = np.asarray(secs + s2)
        n_req = sum(len(q) for q in batches)
        print(f"serve/{name}: {len(batches)} batches x {B}, {layer_line(broker.stats)}, "
              f"{n_req / secs.sum():.1f} requests/s, ms/batch mean {secs.mean() * 1e3:.3f} "
              f"median {np.median(secs) * 1e3:.3f} (host clock, inside Broker.serve), "
              f"dispatches {counts}, kernel launches {launches}")
        out[name] = dict(hits=hits + h2, vals=vals + v2, launches=launches, counts=counts,
                         snap=snap, broker=broker, batches=batches, secs=secs,
                         stats=broker.stats, args=cap.args)
    one, legacy = out["one_call"], out["legacy"]
    nb = len(batches)
    check(one["counts"].get("one_call") == nb, "one one_call dispatch per batch")
    check(one["launches"]["serve_fused"] == nb, "one serve_fused launch per batch")
    check(one["launches"]["probe_and_commit"] == 0, "the one-call path runs no probe_and_commit")
    check(legacy["launches"]["probe_and_commit"] > 0, "the legacy path launched probe_and_commit")
    check(legacy["launches"]["serve_fused"] == 0, "the legacy path runs no serve_fused")
    for i in range(nb):
        check(np.array_equal(one["hits"][i], legacy["hits"][i]), f"hit masks differ at batch {i}")
        check(np.array_equal(one["vals"][i], legacy["vals"][i]), f"values differ at batch {i}")
    print("serve/legacy: hit masks and values identical to the one-call path")
    share = one["stats"].topic_hits / one["stats"].requests
    check(share >= MIN_SET_ASSOC_SHARE,
          f"the set-associative layers answered {share:.6f} of requests "
          f"(< {MIN_SET_ASSOC_SHARE}): the stream does not exercise them")
    profile_window(one["broker"], extra, float(np.median(one["secs"])))
    for r in out.values():
        r["broker"].close()
    return out


def profile_window(broker, batches, batch_s: float):
    """Where a served batch's time goes: device time by kernel (torch
    profiler) against the unprofiled median batch time, and the host's
    busiest functions (cProfile)."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the first session starts the tracer
        broker.serve(batches[0])
    with profile(activities=acts) as prof:
        for q in batches[1:]:
            broker.serve(q)
        torch.cuda.synchronize()
    n = len(batches) - 1
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    check(bool(kern), "the profiler recorded no device time for the served batches")
    busy = sum(e.device_time_total for e in kern) / n / 1e6  # s per batch
    top = sorted(kern, key=lambda e: -e.device_time_total)[:8]
    names = "; ".join(f"{e.key[:70]} {e.device_time_total / n:.1f}us x{e.count / n:.1f}"
                      for e in top)
    print(f"serve/profile: device busy {busy * 1e3:.4f} ms/batch over {n} batches, "
          f"{sum(e.count for e in kern) / n:.1f} device ops/batch, idle share "
          f"{1 - busy / batch_s:.4f} of the unprofiled median {batch_s * 1e3:.3f} ms; "
          f"per batch: {names}")
    pr = cProfile.Profile()
    pr.enable()
    for q in batches:
        broker.serve(q)
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(14)
    for line in buf.getvalue().splitlines():
        if line.strip() and ("{" in line or ".py" in line) and "ncalls" not in line:
            print(f"serve/host-profile: {line.strip()}")


def phase_cpu(cfg, static, true_topic, warm, served):
    from repro_torch.serving import state_from_numpy, state_to_numpy

    batches = served["one_call"]["batches"][:N_CPU_BATCHES]
    broker = make_broker(make_cache("cpu", cfg, static), true_topic, "cpu")
    broker.state = state_from_numpy(warm, "cpu")
    t0 = time.perf_counter()
    hits, vals, _ = serve_stream(broker, batches)
    broker.flush()
    for i in range(N_CPU_BATCHES):
        check(np.array_equal(hits[i], served["one_call"]["hits"][i]), f"cpu hit mask differs at batch {i}")
        check(np.array_equal(vals[i], served["one_call"]["vals"][i]), f"cpu values differ at batch {i}")
    snap = served["one_call"]["snap"]
    mine = state_to_numpy(broker.state)
    for k in snap:
        check(np.array_equal(snap[k], mine[k]), f"cpu state {k} differs from the card's")
    broker.close()
    print(f"cpu: {N_CPU_BATCHES} batches on the plain versions from the warm state identical "
          f"to the card (hit masks, values, flushed state words), {time.perf_counter() - t0:.3f} s")


# -- phase 7: kernels against their plain versions -----------------------------


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def kernel_case(seed: int, s: int, b: int, kind: str):
    """Host arrays of one synthetic serve step: a warm packed state, a
    request batch and the previous batch's fill plan.

    ``uniform`` hashes requests over all ``s`` sets, 60% of them to
    resident keys, with some duplicates, a padded tail, static hits and a
    mix of fresh and stale entries, epochs above 2**31.  ``edge`` crowds
    the batch into 64 sets (deep conflicts), interleaves pads and
    duplicates, puts epochs on both sides of 2**31 with floors saturated at
    2**32 - 1, and makes the fill plan collide.
    """
    rng = np.random.default_rng(seed)
    w, v = WAYS, VDIM
    edge = kind == "edge"
    e0 = (1 << 31) - 2 if edge else (1 << 31) + 1000
    key_hi, key_lo = _words(rng, (s, w)), _words(rng, (s, w))
    key_hi[rng.random((s, w)) < 0.1] = 0  # empty ways
    stamp = rng.integers(0, 1 << 30, size=(s, w)).astype(np.int32)
    epoch = (e0 + rng.integers(-4, 5, size=(s, w))).astype(np.uint32)
    ks = np.concatenate([key_hi, key_lo, stamp.view(np.uint32), epoch], 1)
    value = rng.integers(0, 1 << 31, size=(s * w, v)).astype(np.int32)
    n_sets = 64 if edge else s
    set_idx = rng.integers(0, n_sets, size=b).astype(np.int32)
    h_hi, h_lo = _words(rng, b), _words(rng, b)
    res = rng.random(b) < 0.6
    way = rng.integers(0, w, size=b)
    h_hi[res] = key_hi[set_idx[res], way[res]]
    h_lo[res] = key_lo[set_idx[res], way[res]]
    dup = rng.integers(0, b, size=b // (4 if edge else 10))
    tail = np.arange(b - len(dup), b)
    h_hi[tail], h_lo[tail], set_idx[tail] = h_hi[dup], h_lo[dup], set_idx[dup]
    pads = np.arange(0, b, 13) if edge else np.arange(b - 96, b)
    h_hi[pads] = h_lo[pads] = 0xFFFFFFFF
    admit = rng.random(b) < (0.7 if edge else 1.0)
    static_hit = rng.random(b) < 0.3
    epochs = np.full(b, e0 + 6, np.uint32)
    min_epoch = (e0 + rng.integers(-6, 6, size=b)).astype(np.uint32)
    if edge:
        min_epoch[rng.random(b) < 0.1] = 0xFFFFFFFF
    n_fill = b // 2
    f_set = rng.integers(0, n_sets, size=n_fill).astype(np.int32)
    f_way = rng.integers(0, w, size=n_fill).astype(np.int32)
    f_vals = rng.integers(0, 1 << 31, size=(n_fill, v)).astype(np.int32)
    return dict(
        ks=ks, value=value, set_idx=set_idx, h_hi=h_hi, h_lo=h_lo, admit=admit,
        static_hit=static_hit, epochs=epochs, min_epoch=min_epoch,
        clock=np.int32(1 << 30), f_set=f_set, f_way=f_way, f_vals=f_vals,
    )


def kernel_args(case, device):
    """A synthetic case as the serve wrapper's arguments on ``device``:
    ``(ks, value, f_slot, f_vals, *common)``, where ``common`` is also the
    tail of the probe/commit wrapper's arguments after ``ks``."""
    from repro_torch.kernels.cache_ops import fill_winner_slots, plan_segments
    from repro_torch.serving.device_cache import to_device_words

    t = {k: to_device_words(np.asarray(a), device) if np.asarray(a).dtype != bool
         else torch.from_numpy(a).to(device) for k, a in case.items()}
    s, w4 = t["ks"].shape
    w = w4 // 4
    order, _, leader, seg_len, seg_set = plan_segments(t["set_idx"])
    f_slot = fill_winner_slots(
        s * w, w, t["f_set"], torch.ones_like(t["f_set"], dtype=torch.bool), t["f_way"]
    )
    return (t["ks"], t["value"], f_slot, t["f_vals"], order, leader, seg_len, seg_set,
            t["h_hi"], t["h_lo"], t["admit"], t["static_hit"], t["epochs"],
            t["min_epoch"], t["clock"])


def kernel_bytes(ks, common, value=None, f_slot=None, pre_way=None) -> int:
    """Bytes the function must move for this batch: each input read once,
    each output written once.  That is the rows of the sets the batch
    touches (read and written back), the request fields and segment plan,
    and the per-request outputs; for the serve kernel (``value``,
    ``f_slot`` and the probed ways ``pre_way`` given) also the fill plan,
    the filled slots, each distinct gathered value row and the served
    rows."""
    order, leader, seg_len, seg_set = (x.cpu().numpy().astype(np.int64) for x in common[:4])
    s, w4 = ks.shape
    b = len(order)
    real = seg_len > 0
    n_seg = int(real.sum())
    n_rows = int((real & (seg_set < s)).sum())
    total = b * (4 + 4 + 1 + 1 + 4 + 4 + 4)  # h_hi, h_lo, admit, static, epochs, minep, order
    total += b * 4 + n_seg * 8 + 4  # seg_len per thread, leader + set per segment, clock
    total += 2 * n_rows * w4 * 4  # rows read and written back
    total += b * (1 + 4 + 1 + 4 + 1 + 4)  # per-request outputs
    if value is None:
        return total
    nslots, v = value.shape
    fs = f_slot.cpu().numpy()
    n_fill = int(((fs >= 0) & (fs < nslots)).sum())
    total += len(fs) * 4 + 2 * n_fill * v * 4  # slots; values read and written
    # each request's set, from its segment: sorted positions leader..+len
    lens = seg_len[real]
    sorted_pos = np.repeat(leader[real] - np.cumsum(lens) + lens, lens) + np.arange(lens.sum())
    req_set = np.empty(b, np.int64)
    req_set[order[sorted_pos]] = np.repeat(seg_set[real], lens)
    rows = np.minimum(req_set, s - 1) * (w4 // 4) + pre_way.cpu().numpy()
    return total + len(np.unique(rows)) * v * 4 + b * v * 4


def time_device(fn, n: int, flush, restore) -> float:
    """Mean device time of ``fn`` (ms): the launches are queued behind a
    spin kernel so the host never starves the card; before each launch the
    state is restored and the L2 flushed (a serving batch finds its sets
    cold), outside the timed span."""
    restore()
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        restore()
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in events]))


def time_host(fn, n: int, flush, restore) -> float:
    """Mean time of ``fn`` from its first enqueue to its last kernel's end
    (ms), host work included: for the plain versions, which synchronise."""
    total = 0.0
    for i in range(n + 1):
        restore()
        flush.zero_()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i:  # the first call warms up
            total += start.elapsed_time(end)
    return total / n


def _max_err(a, b) -> int:
    err = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape and x.dtype == y.dtype, "kernel/plain output layout")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def phase_kernels(device, served):
    from repro_torch.kernels.cache_ops import kernel as pac
    from repro_torch.kernels.cache_ops import ref
    from repro_torch.kernels.cache_ops import serve_kernel as srv

    flush = torch.empty(1 << 26, dtype=torch.int32, device=device)  # 256 MiB > L2
    rows = {name: dict(max_abs_err=0) for name in ("serve_fused", "probe_and_commit")}
    stream_srv = served["one_call"]["args"]
    stream_pac = served["legacy"]["args"]
    check(stream_srv is not None and stream_pac is not None, "captured the serving batch's launches")
    cases = [("stream", stream_srv, stream_pac)]
    for i, kind in enumerate(("uniform", "edge")):
        args = kernel_args(kernel_case(SEED + i, 1 << 18, B, kind), device)
        cases.append((kind, args, (args[0], *args[4:])))
    for label, sargs, pargs in cases:
        ks, val, f_slot, f_vals, *common = sargs
        # serve_fused: kernel vs plain on identical clones
        ks_k, val_k, ks_p, val_p = ks.clone(), val.clone(), ks.clone(), val.clone()
        got = srv.serve_fused(ks_k, val_k, f_slot, f_vals, *common)
        want_srv = ref.serve_fused_plain(ks_p, val_p, f_slot, f_vals, *common)
        torch.cuda.synchronize()
        err = _max_err((ks_k, val_k, *got), (ks_p, val_p, *want_srv))
        check(err == 0, f"serve_fused kernel != plain on the {label} batch (max err {err})")
        rows["serve_fused"]["max_abs_err"] = max(rows["serve_fused"]["max_abs_err"], err)
        # probe_and_commit
        pks, *pcommon = pargs
        ks_k, ks_p = pks.clone(), pks.clone()
        got = pac.probe_and_commit(ks_k, *pcommon)
        want = ref.probe_and_commit_plain(ks_p, *pcommon)
        torch.cuda.synchronize()
        err = _max_err((ks_k, *got), (ks_p, *want))
        check(err == 0, f"probe_and_commit kernel != plain on the {label} batch (max err {err})")
        rows["probe_and_commit"]["max_abs_err"] = max(rows["probe_and_commit"]["max_abs_err"], err)
        seg_len = common[2]
        print(f"kernels/{label}: equal to plain (B={len(seg_len)} S={ks.shape[0]} "
              f"W={ks.shape[1] // 4} V={val.shape[1]}, segments={int((seg_len > 0).sum())} "
              f"depth={int(seg_len.max())}, fill slots={int((f_slot < val.shape[0]).sum())})")
        if label == "edge":
            continue
        n = 100
        ks_t, val_t, pks_t = ks.clone(), val.clone(), pks.clone()

        def restore_srv():
            ks_t.copy_(ks)
            val_t.copy_(val)

        def restore_pac():
            pks_t.copy_(pks)

        run_srv = lambda: srv.serve_fused(ks_t, val_t, f_slot, f_vals, *common)  # noqa: E731
        run_pac = lambda: pac.probe_and_commit(pks_t, *pcommon)  # noqa: E731
        if label == "uniform":
            for name, fn, restore in (("serve_fused", run_srv, restore_srv),
                                      ("probe_and_commit", run_pac, restore_pac)):
                print(f"kernels/{name}/uniform: device "
                      f"{time_device(fn, n, flush, restore):.6f} ms/launch (L2 flushed)")
            continue
        rows["serve_fused"].update(
            ms=time_device(run_srv, n, flush, restore_srv),
            plain_ms=time_host(
                lambda: ref.serve_fused_plain(ks_t, val_t, f_slot, f_vals, *common), 20,
                flush, restore_srv),
            bound_ms=kernel_bytes(ks, common, val, f_slot, want_srv[2]) / HBM_BYTES_PER_S * 1e3,
            wrapper_ms=time_host(run_srv, n, flush, restore_srv),
        )
        rows["probe_and_commit"].update(
            ms=time_device(run_pac, n, flush, restore_pac),
            plain_ms=time_host(lambda: ref.probe_and_commit_plain(pks_t, *pcommon), 20,
                               flush, restore_pac),
            bound_ms=kernel_bytes(pks, pcommon) / HBM_BYTES_PER_S * 1e3,
            wrapper_ms=time_host(run_pac, n, flush, restore_pac),
        )
    del flush
    for name, r in rows.items():
        print(f"kernels/{name}/stream: device {r['ms']:.6f} ms/launch (L2 flushed), with the "
              f"wrapper's host work {r['wrapper_ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
              f"byte bound {r['bound_ms']:.6f} ms")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = card_line()
    device = torch.device("cuda")
    print(f"card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} for sm_90a in {time.perf_counter() - t0:.3f} s")
    for name, (_, report) in libs.items():
        if not report:
            print(f"ptxas/{name}: library reused from build/kernels, no report")
        for line in report.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas/{name}: {line.strip()}")

    t0 = time.perf_counter()
    cfg, train, serve, true_topic = make_stream(SEED)
    share = float(np.mean(true_topic[serve] >= 0))
    print(f"stream: SynthConfig x{SCALE} (seed {SEED}): {len(train)} training + {len(serve)} "
          f"served requests over {len(true_topic)} query ids, served topical share "
          f"{share:.6f} (config {cfg.topical_fraction}), generated in "
          f"{time.perf_counter() - t0:.3f} s")
    check(abs(share - cfg.topical_fraction) <= TOPICAL_TOL,
          f"served topical share {share:.6f} is not the config's {cfg.topical_fraction}")
    t0 = time.perf_counter()
    ccfg, static, n_distinct = plan_cache(train, true_topic)
    cache = make_cache(device, ccfg, static)
    print(f"cache: {ccfg.total_entries} entries = {cache.n_sets} sets x {WAYS} ways + "
          f"{len(static)} static keys, {cache.k} topic partitions; "
          f"{ccfg.total_entries / n_distinct:.6f} of the training prefix's {n_distinct} "
          f"distinct queries; planned in {time.perf_counter() - t0:.3f} s")

    first = make_broker(cache, true_topic, device)
    warm = phase_warm(first, train)
    served = phase_serve(device, cache, true_topic, first, warm, serve)
    phase_cpu(ccfg, static, true_topic, warm, served)
    rows = phase_kernels(device, served)

    kernels = []
    # each kernel's launches come from the run of the path that uses it
    for name, path, replaces in (
        ("serve_fused", "one_call", "src/repro/kernels/cache_ops/serve_kernel.py:203"),
        ("probe_and_commit", "legacy", "src/repro/kernels/cache_ops/kernel.py:215"),
    ):
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/cache_ops.cu",
            replaces=replaces, launches=served[path]["launches"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes", library_ms=None,
        ))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
