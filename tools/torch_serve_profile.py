"""The serving CLI's open loop on the card with its LM back end eager and
as CUDA graphs, and a profile of where a batch's host time goes.

    PYTHONPATH=src python tools/torch_serve_profile.py [--requests N] [--top N]

Builds the kernels, runs ``repro_torch.launch.serve.main`` once in a
closed loop to warm up, then its open loop with shard 2 crashing halfway
(the flags of ``chip_smoke.py``'s phase cluster) four times: the back end
eager (``lm_backend(graph_max=0)``), graphed, graphed, eager.  Each run
prints the CLI's own lines (latency percentiles, SLO verdict,
availability) and its exit code and seconds.  Then one eager and one
graphed run under cProfile, each followed by its heaviest functions by
cumulative time.  Needs one CUDA card.
"""
import argparse
import cProfile
import io
import pstats
import sys
import time

sys.path.insert(0, "src")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=2_000_000)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s")
    base = ["--requests", str(args.requests), "--entries", "65536", "--batch", "4096",
            "--shards", "4"]
    # the crash halfway through the open loop's test stream, as chip_smoke.py
    # places it: 0.7 x the batch policy's capacity of 482336 requests/s
    t_crash = 0.5 * (args.requests - args.requests // 2) / (0.7 * 482336)
    closed = base + ["--routing", "topic", "--pipeline", "8"]
    open_loop = base + ["--open-loop", "--fault-shard", f"2@{t_crash:.6f}",
                        "--min-availability", "1.0"]
    graphed_backend = serve.lm_backend

    def eager_backend(*a, **kw):
        kw["graph_max"] = 0
        return graphed_backend(*a, **kw)

    def run(name, argv, prof=None):
        serve.lm_backend = eager_backend if name == "eager" else graphed_backend
        try:
            t0 = time.perf_counter()
            if prof is not None:
                prof.enable()
            rc = serve.main(argv)
            if prof is not None:
                prof.disable()
            print(f"run/{name}: returned {rc} in {time.perf_counter() - t0:.3f} s", flush=True)
        finally:
            serve.lm_backend = graphed_backend

    run("graphed", closed)
    for name in ("eager", "graphed", "graphed", "eager"):
        run(name, open_loop)
    for name in ("eager", "graphed"):
        prof = cProfile.Profile()
        run(name, open_loop, prof)
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(args.top)
        print(f"profile/{name}:\n{out.getvalue()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
