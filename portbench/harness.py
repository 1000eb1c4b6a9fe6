"""One run of one cell: set-up, the measured window, the checks, the result.

A cell names a configuration (``configs/<config>.json``: the back-end
model, the cache deployment, the stream) and a traffic mix
(``traffic/<mix>.json``); every metric named in ``BENCHMARK.json`` is read
by ``metrics/<name>.py``.  The harness finds them all by name, so a new
configuration, mix or metric is a new file.

The timed path is the serving CLI's at full width: a ``Cluster`` compiled
from a ``ServingSpec`` with the LM back end (``lm_backend``, CUDA graphs up
to the largest batch) behind it, its static layer filled through that back
end, its topics the stream's own.  The benchmark wraps the back end to
time and record each call; its spans are ``serve`` (one ``Cluster.serve``),
``backend`` (one back-end call) and ``queue`` (from a call's oldest due
request to the call's start).
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

import arith
import weights as weights_mod
from refcache import Plan, Replay, split_sizes
from refmodel import Reference, row_gaps, top_ids
from stream import StreamConfig, arrival_times, draw_stream, query_tokens

#: top-level modules that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: seconds past the window's close that the open loop waits for answers
DRAIN_LIMIT_S = 60.0


def log(t_start: float, what: str) -> None:
    print(f"portbench: {time.perf_counter() - t_start:8.2f} s {what}", file=sys.stderr, flush=True)


class Fail(Exception):
    """A run that cannot give a result (bad cell, no card, forbidden
    import): the message goes to standard error, the exit code is not 0."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, name: str):
    bench = load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise Fail(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    here = Path(__file__).resolve().parent
    cfg = load_json(here / "configs" / f"{cell['config']}.json")
    mix = load_json(here / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, cfg, mix


def metrics_for(bench: dict, cell: dict, trace: bool) -> List[dict]:
    """The metrics the cell reports: its end-to-end ones with ``trace`` 0,
    its per-layer ones with 1 (those listing the cell, or listing none and
    moving an end-to-end metric the cell reports)."""
    def mine(m):
        return cell["name"] in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(name: str):
    import importlib.util

    path = Path(__file__).resolve().parent / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def transformer_config(tf, m: dict):
    moe = None
    if m.get("n_experts"):
        moe = tf.MoEConfig(n_experts=m["n_experts"], top_k=m["top_k"], d_ff=m["expert_d_ff"],
                           dense_residual_ff=m.get("dense_residual_ff", 0),
                           capacity_factor=m["capacity_factor"])
    return tf.TransformerConfig(
        n_layers=m["n_layers"], d_model=m["d_model"], n_heads=m["n_heads"],
        n_kv_heads=m["n_kv_heads"], head_dim=m["head_dim"], d_ff=m["d_ff"],
        vocab_size=m["vocab_size"], activation="silu", rope_theta=m["rope_theta"],
        qkv_bias=m["qkv_bias"], norm_eps=m["norm_eps"], moe=moe, dtype=torch.bfloat16)


class Recorder:
    """The back end as the cluster sees it: each call timed and recorded."""

    def __init__(self, backend, spans):
        self.backend, self.spans = backend, spans
        self.calls: List[SimpleNamespace] = []
        self.serve_call = -1  # the serve call under way (-1 in set-up)

    def __call__(self, qids: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        out = self.backend(qids)
        t1 = time.perf_counter()
        self.spans.append(("backend", t0, t1))
        self.calls.append(SimpleNamespace(serve=self.serve_call, qids=np.array(qids),
                                          out=np.array(out), t0=t0, t1=t1))
        return out

    def static_fill(self, chunk: int):
        """``value_fn``: the static keys through the back end, ``chunk``
        (its largest graph) at a time."""
        def fill(keys):
            keys = np.asarray(keys)
            return np.concatenate([self(keys[i:i + chunk]) for i in range(0, len(keys), chunk)])
        return fill


def closed_loop(serve, n: int, seconds: float, batch: int, t0: float) -> int:
    """Batches of ``batch`` requests, one serve call at a time, until the
    window has passed; returns the requests served."""
    i = 0
    while time.perf_counter() - t0 < seconds and i + batch <= n:
        serve(i, i + batch)
        i += batch
    return i


def open_loop(serve, due: np.ndarray, seconds: float, batch: int, t0: float, spans) -> int:
    """Requests due at ``t0 + due`` (all within the window): each time the
    server is free it serves, in order, every request already due, up to
    ``batch``; requests still waiting when the window closes are served
    after it, for at most ``DRAIN_LIMIT_S``.  Returns the requests served."""
    i, n = 0, len(due)
    while i < n:
        now = time.perf_counter() - t0
        if now > seconds + DRAIN_LIMIT_S:
            break
        if due[i] > now:
            if due[i] - now > 2e-4:
                time.sleep(due[i] - now - 1e-4)
            continue
        j = min(int(np.searchsorted(due, now, side="right")), i + batch, n)
        spans.append(("queue", t0 + due[i], time.perf_counter()))
        serve(i, j)
        i = j
    return i


def stream_config(s: dict, seed: int) -> StreamConfig:
    """The configuration's stream.  A configuration may fix its stream's
    seed: the work is then the same on every run, and the run's seed draws
    the weights, the arrival instants and the checked sample."""
    return StreamConfig.scaled(s["scale"], s.get("seed", seed), **s.get("overrides", {}))


def check_modules(names=None) -> List[str]:
    """The forbidden top-level packages among ``names`` (default: those
    loaded), compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def setup(root: Path, name: str, seed: int, t_start: float, device: str = "cuda"):
    """Everything before a window: the cell's inputs from ``seed``, the
    program built as the CLI builds it, its static layer filled through the
    back end and its cache warmed.  Returns the run's state, whose
    ``serve(lo, hi, phase)`` serves ``test[lo:hi]`` as one call and records
    it in ``calls``; ``pos`` is the next request of ``test``."""
    bench, cell, cfg, mix = find_cell(root, name)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Fail(f"{name} needs {cell['chips']} CUDA device(s); "
                       f"torch.cuda.is_available()={torch.cuda.is_available()}")
        torch.cuda.set_device(dev)
    sys.path.insert(0, str(root / "src"))
    try:
        from repro_torch.core.fast import VecLog, VecStats
        from repro_torch.core.spec import CacheSpec
        from repro_torch.launch.serve import lm_backend
        from repro_torch.models import transformer as tf
        from repro_torch.serving import BucketSpec, Cluster, HedgeSpec, ServingSpec
    except ImportError as e:
        raise Fail(f"the program is not in this checkout ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, c, s = cfg["model"], cfg["cache"], cfg["stream"]
    seed = int(seed) & ((1 << 63) - 1)

    scfg = stream_config(s, seed)
    keys, true_topic = draw_stream(scfg)
    log(t_start, f"stream: {len(keys)} requests over {len(true_topic)} query ids")
    n_train = int(len(keys) * s["train_frac"])
    test = keys[n_train:]
    stats = VecStats.from_log(VecLog(keys=keys, n_train=n_train, key_topic=true_topic))
    batch = int(mix["batch"])
    spec = ServingSpec(
        cache=CacheSpec.from_strategy(c["strategy"], c["entries"], f_s=c["f_s"], f_t=c["f_t"]),
        shards=c["shards"], routing=c["routing"], microbatch=batch, value_dim=c["value_dim"],
        ways=c["ways"], hedge=HedgeSpec(deadline_s=2.0))
    log(t_start, "training statistics")
    w = weights_mod.make(m, seed, dev)
    log(t_start, "weights")
    params = tf.ParamTree(weights_mod.tree(w))
    mcfg = transformer_config(tf, m)
    spans: List[tuple] = []
    rec = Recorder(lm_backend(params, mcfg, c["value_dim"], device=dev, graph_max=batch), spans)
    cluster = Cluster.from_spec(spec, stats, [rec], topic_of=lambda q: true_topic[q],
                                value_fn=rec.static_fill(batch), device=dev)
    log(t_start, f"graphs captured, static layer filled ({len(rec.calls)} back-end calls)")
    cluster.warmup()
    log(t_start, "bucket shapes warmed")

    st = SimpleNamespace(
        bench=bench, cell=cell, cfg=cfg, mix=mix, dev=dev, seed=seed, keys=keys,
        n_train=n_train, true_topic=true_topic, test=test, batch=batch, w=w, params=params,
        rec=rec, cluster=cluster, spans=spans, pos=0, min_bucket=BucketSpec().min_size,
        calls=[],  # every serve call: lo, hi, t0, t1, phase
        served_vals=np.zeros((len(test), c["value_dim"]), np.int32),
        served_hit=np.zeros(len(test), bool))

    def serve(lo: int, hi: int, phase: str):
        rec.serve_call = len(st.calls)
        t0 = time.perf_counter()
        v, h = st.cluster.serve(test[lo:hi])
        t1 = time.perf_counter()
        if phase == "window":
            spans.append(("serve", t0, t1))
        st.served_vals[lo:hi], st.served_hit[lo:hi] = v, h
        st.calls.append(SimpleNamespace(idx=len(st.calls), lo=lo, hi=hi, t0=t0, t1=t1,
                                        phase=phase, n=hi - lo))

    st.serve = serve
    # the cache warms until its set-associative part has taken as many
    # misses as it has entries
    n_s, _, _ = split_sizes(c["entries"], c["f_s"], c["f_t"])
    while True:
        now = cluster.stats
        if now.requests - now.hits >= c["entries"] - n_s:
            break
        if st.pos + batch > len(test):
            raise Fail("the stream ran out while the cache warmed: raise its scale")
        serve(st.pos, st.pos + batch, "warm")
        st.pos += batch
    log(t_start, f"cache warmed in {len(st.calls)} batches")
    return st


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", control: bool = False) -> dict:
    """One run of cell ``name``.  With ``control`` the fp8 reference's ids
    stand in for the back end's answers where the back end is judged: the
    run must then come out not correct."""
    st = setup(root, name, seed, t_start, device)
    bench, cell, cfg, mix, dev = st.bench, st.cell, st.cfg, st.mix, st.dev
    m, seed, batch, serve = cfg["model"], st.seed, st.batch, st.serve
    test, calls, spans, rec, cluster = st.test, st.calls, st.spans, st.rec, st.cluster

    dtrace = None
    if trace:
        from trace import DeviceTrace
        dtrace = DeviceTrace(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    before = cluster.stats
    setup_s = time.perf_counter() - t_start

    # -- the window ------------------------------------------------------------
    first = len(calls)
    w_lo = st.pos
    due = None
    if dtrace is not None:
        dtrace.start()
    t0 = time.perf_counter()
    if mix["loop"] == "closed":
        n = (len(test) - w_lo) // batch * batch
        done = closed_loop(lambda i, j: serve(w_lo + i, w_lo + j, "window"), n, seconds, batch, t0)
        if done >= n:
            raise Fail("the stream ran out in the window: raise its scale")
        t_end = calls[-1].t1
        n_due = done
    else:
        a = mix["arrivals"]
        n_max = min(len(test) - w_lo, int(a["rate"] * seconds * 1.5) + 1024)
        due = arrival_times(a["process"], a["rate"], n_max, seed + 1,
                            **{k: v for k, v in a.items() if k not in ("process", "rate")})
        n_due = int(np.searchsorted(due, seconds))
        if n_due >= n_max:
            raise Fail("the stream ran out in the window: raise its scale")
        due = due[:n_due]
        open_loop(lambda i, j: serve(w_lo + i, w_lo + j, "window"), due, seconds, batch, t0,
                  spans)
        t_end = t0 + seconds
    if dtrace is not None:
        dtrace.stop()
        import readers
        names = sorted({n for n, _, _ in dtrace.ops if readers.is_serve_kernel(n)})
        log(t_start, f"traced {len(dtrace.ops)} device ops; serve kernels {names}")
    rec.serve_call = -1
    after = cluster.stats
    cluster.flush()
    window = calls[first:]
    broker = cluster.brokers[0]
    state = {k: broker.state[k].detach().cpu().numpy() for k in ("ks", "value")}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    d_req, d_hit = after.requests - before.requests, after.hits - before.hits
    log(t_start, f"window closed: {len(window)} serve calls, {sum(x.n for x in window)} requests, "
                 f"hit rate {d_hit / max(d_req, 1):.4f}, {after.backend_calls - before.backend_calls}"
                 f" back-end calls, peak {peak / 2**30:.2f} GiB")
    # -- the program's state is freed before the checks --------------------------
    cluster.close()
    del cluster, broker
    st.cluster = st.params = rec.backend = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run = SimpleNamespace(
        cell=cell, cfg=cfg, mix=mix, seed=seed, seconds=seconds, t0=t0, t_end=t_end,
        setup_s=setup_s, spans=spans, window=window, due=due, n_due=n_due, w_lo=w_lo,
        backend_calls=[b for b in rec.calls if b.serve >= first], before=before, after=after,
        trace=dtrace, row_flops=arith.row_flops(m), model=m, window_prev=calls[first - 1],
        min_bucket=st.min_bucket)
    checks = check(run, cfg, test, st.true_topic, st.keys[:st.n_train], calls, st.served_vals,
                   st.served_hit, rec.calls, state, st.w, dev, seed, control)
    st.w = None
    log(t_start, "checked")
    values = {}
    for metric in metrics_for(bench, cell, trace):
        v = reader(metric["name"])(run)
        if v is not None:
            values[metric["name"]] = {"value": float(v), "unit": metric["unit"]}
    loaded = check_modules()
    if loaded:
        raise Fail(f"forbidden modules loaded in the run: {loaded}")
    ok = all(v <= lim for v, lim in checks.values())
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": bool(ok), "attempted": int(n_due),
           "failed": int(n_due - sum(x.n for x in window)), "metrics": values,
           "device": device_info}
    if dtrace is not None:
        device_info["busy_s"] = dtrace.busy_s
        device_info["window_s"] = dtrace.window_s
        out["breakdown"] = {"device_ops": dtrace.top_ops(10),
                            "idle_gaps": dtrace.idle_gaps(spans, 10)}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def check(run, cfg, test, true_topic, train_keys, calls, served_vals, served_hit, bcalls,
          state, w, dev, seed, control) -> Dict[str, tuple]:
    """The comparison that decides ``correct``: ``{name: (value, limit)}``,
    each value at most its limit."""
    c, m, lim = cfg["cache"], cfg["model"], cfg["limits"]
    out = {}
    # accounting: each request due in the window answered once, in order
    win = run.window
    n_answered = sum(x.n for x in win)
    in_order = (all(win[i].hi == win[i + 1].lo for i in range(len(win) - 1))
                and (not win or win[0].lo == run.w_lo))
    stats_n = run.after.requests - run.before.requests
    missing = run.n_due - n_answered + abs(stats_n - n_answered) + (0 if in_order else run.n_due)
    out["unanswered"] = (float(missing), 0.0)

    # the cache: every served request replayed on the plan
    plan = Plan(train_keys, true_topic, c["entries"], c["f_s"], c["f_t"], c["ways"])
    bounds = np.array([calls[0].lo] + [x.hi for x in calls])
    upto = calls[-1].hi
    q = test[:upto]
    rp = Replay(plan)
    layer, src = rp.run(q, bounds)
    run.replay = rp
    bad = int(((layer >= 0) != served_hit[:upto]).sum())
    sh = layer == 1
    bad += int((served_vals[:upto][sh] != served_vals[:upto][src[sh]]).any(axis=1).sum())
    # static answers: the fill's back-end answers, for exactly the plan's keys
    fill = [b for b in bcalls if b.serve < 0]
    f_keys = np.concatenate([b.qids for b in fill]) if fill else np.zeros(0, np.int64)
    f_vals = np.concatenate([b.out for b in fill]) if fill else np.zeros((0, c["value_dim"]))
    if not np.array_equal(np.sort(f_keys), plan.static_keys):
        bad += len(plan.static_keys) + 1
    else:
        order = np.argsort(f_keys)
        st = layer == 0
        at = np.searchsorted(f_keys[order], q[st])
        bad += int((served_vals[:upto][st] != f_vals[order][at]).any(axis=1).sum())
    # misses: one back-end call per serve call with a miss, over the
    # batch's distinct missed ids, and each miss answered with its row
    by_serve: Dict[int, list] = {}
    for b in bcalls:
        if b.serve >= 0:
            by_serve.setdefault(b.serve, []).append(b)
    for j, x in enumerate(calls):
        miss = np.flatnonzero(layer[x.lo:x.hi] < 0) + x.lo
        got = by_serve.get(j, [])
        want = np.unique(q[miss])
        ids = np.concatenate([b.qids for b in got]) if got else np.zeros(0, np.int64)
        if not np.array_equal(ids, want):
            bad += len(miss) + 1
            continue
        if len(miss):
            outs = np.concatenate([b.out for b in got])
            bad += int((served_vals[miss] != outs[np.searchsorted(ids, q[miss])]).any(axis=1).sum())
    # the counters over the window
    wl = slice(run.w_lo, upto)
    d = {k: getattr(run.after, k) - getattr(run.before, k)
         for k in ("requests", "hits", "static_hits", "topic_hits")}
    want = {"requests": upto - run.w_lo, "hits": int((layer[wl] >= 0).sum()),
            "static_hits": int((layer[wl] == 0).sum()), "topic_hits": int((layer[wl] == 1).sum())}
    bad += sum(d[k] != want[k] for k in d)
    # the state at the window's end: each slot's key and value
    ks, val = state["ks"].view(np.uint32), state["value"]
    r_key, r_src = rp.state()
    wy = c["ways"]
    if ks.shape[0] != plan.n_sets:
        bad += plan.n_sets * wy
    else:
        key = (ks[:, :wy].astype(np.uint64) << np.uint64(32)) | ks[:, wy:2 * wy].astype(np.uint64)
        bad += int((key != r_key).sum())
        r_val = np.where((r_src >= 0)[..., None], served_vals[np.maximum(r_src, 0)], 0)
        bad += int((val != r_val).any(axis=-1).sum())
    out["cache_mismatches"] = (float(bad), 0.0)

    # the back end: a sample of the window's calls against the reference;
    # the control's ids are judged in the served ids' place
    fp8 = (Reference(m, w, "fp8").last_logits,) if control else ()
    gaps, stood_in = backend_gap(run, m, w, dev, seed, c["value_dim"], fp8)
    judged = stood_in[0] if control else gaps
    for name, limit in lim.items():
        out[name] = (gap_stat(name, judged), float(limit))
    return out


def gap_stat(name: str, rows: np.ndarray) -> float:
    """``backend_gap``: the widest gap over the sampled rows;
    ``backend_gap_p90``: the 90th percentile of the rows' widest gaps;
    ``backend_rows_over_<t>``: the share of the rows whose gap passes t."""
    if not len(rows):
        return float("inf")
    if name == "backend_gap":
        return float(rows.max())
    if name == "backend_gap_p90":
        return float(np.percentile(rows, 90))
    if name.startswith("backend_rows_over_"):
        return float((rows > float(name[len("backend_rows_over_"):])).mean())
    raise ValueError(f"unknown limit {name!r}")


def backend_gap(run, m, w, dev, seed, k, stand_ins=()):
    """Each sampled row's widest logit gap of the served ids, and of the ids
    that each of ``stand_ins`` (tokens -> last logits, such as the fp8
    reference) puts first on the same rows: ``(gaps, [gaps of each])``.
    The sample is drawn from the seed: rows of the window's back-end calls
    (a dense model scores each row alone), or whole calls (an expert
    layer's drops depend on the whole call, its padding rows included)."""
    calls = run.backend_calls
    if not calls:
        return np.zeros(0), [np.zeros(0) for _ in stand_ins]
    rng = np.random.default_rng([seed, 7])
    samp = run.mix.get("check", {})
    ref = Reference(m, w, "bf16")
    gaps, sgaps = [], [[] for _ in stand_ins]

    def judge(t, n, served):
        lg = ref.last_logits(t)[:n]
        gaps.append(row_gaps(lg, torch.from_numpy(served).to(dev)))
        for fn, out in zip(stand_ins, sgaps):
            out.append(row_gaps(lg, top_ids(fn(t)[:n], k)))

    if m.get("n_experts"):
        batch = int(run.mix["batch"])
        for ci in rng.choice(len(calls), size=min(samp.get("calls", 2), len(calls)), replace=False):
            b = calls[int(ci)]
            n = len(b.qids)
            # the card replays the graph of the next power of two of rows
            rows = arith.pow2(n) if n <= batch and dev.type == "cuda" else n
            tok = np.zeros((rows, 8), np.int64)
            tok[:n] = query_tokens(b.qids, m["vocab_size"])
            judge(torch.from_numpy(tok).to(dev), n, b.out)
    else:
        rows = [(ci, r) for ci, b in enumerate(calls) for r in range(len(b.qids))]
        pick = rng.choice(len(rows), size=min(samp.get("rows", 64), len(rows)), replace=False)
        qids = np.array([calls[rows[p][0]].qids[rows[p][1]] for p in pick])
        served = np.stack([calls[rows[p][0]].out[rows[p][1]] for p in pick])
        judge(torch.from_numpy(query_tokens(qids, m["vocab_size"])).to(dev), len(pick), served)
    return np.concatenate(gaps), [np.concatenate(g) for g in sgaps]
