"""One-pass cache-size sweep on the port: the reuse-distance engine's trick.

A single trace analysis yields the exact LRU hit count for EVERY cache
size at once (Mattson's stack property): the paper's whole size grid from
one pass over the stream, on the card.  ``examples/cache_size_sweep.py``
on ``repro_torch``.

  PYTHONPATH=src python examples/torch_cache_size_sweep.py [--device cpu]
"""
import argparse
import sys
import time

from repro_torch.core import lru_hits_all_sizes
from repro_torch.querylog import SynthConfig, generate
from repro_torch.topics import oracle_pipeline

SIZES = (1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=400_000)
    ap.add_argument("--max-cap", type=int, default=131_072,
                    help="the largest cache size the pass counts")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the log and the analysis run (default: the card)")
    args = ap.parse_args(argv)

    synth = generate(SynthConfig(n_requests=args.requests, n_topics=32,
                                 n_topical_queries=80_000, n_notopic_queries=40_000,
                                 vocab_size=512, seed=1), device=args.device)
    pipe = oracle_pipeline(synth, train_frac=0.7, device=args.device)
    n_test = len(pipe.log.test_keys)

    t0 = time.perf_counter()
    hits = lru_hits_all_sizes(pipe.log, max_cap=args.max_cap, device=args.device)
    print(f"one pass over {len(synth.keys):,} requests on {args.device}: "
          f"{time.perf_counter() - t0:.1f}s")
    print("LRU hit rate at EVERY cache size (from that single pass):")
    for n in (n for n in SIZES if n <= args.max_cap):
        print(f"  N={n:>7,}: {hits[n] / n_test:.4f}  ({int(hits[n])} of {n_test} hits)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
