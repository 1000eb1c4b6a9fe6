"""Quickstart on the port: the paper's experiment in ~40 lines, on the card.

Generates a calibrated query log, discovers topics with LDA, and compares
SDC against the STD cache variants at one cache size, printing the hit
rates and the Bélády bound: ``examples/quickstart.py`` on ``repro_torch``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import sys

import numpy as np

from repro_torch.core import STRATEGIES, CacheSpec, belady_hits, hit_rate
from repro_torch.querylog import SynthConfig, generate
from repro_torch.topics import run_pipeline


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=200_000)
    ap.add_argument("--lda-iters", type=int, default=15)
    ap.add_argument("--lda-subsample", type=int, default=8_000)
    ap.add_argument("--entries", type=int, default=4096, help="cache size N")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the log, LDA and the analysis run (default: the card)")
    args = ap.parse_args(argv)

    # 1) a synthetic query log with the structure the paper measures on
    #    AOL/MSN: Zipf query popularity, per-topic temporal locality,
    #    singleton floods
    cfg = SynthConfig(n_requests=args.requests, n_topics=32, n_topical_queries=40_000,
                      n_notopic_queries=20_000, vocab_size=1024, seed=0)
    synth = generate(cfg, device=args.device)

    # 2) the paper's topic pipeline: LDA over query + clicked-document text,
    #    click-voted query->topic assignment, topic popularity estimation
    pipe = run_pipeline(synth, train_frac=0.7, lda_iters=args.lda_iters,
                        lda_subsample=args.lda_subsample, device=args.device)
    print(f"topical test requests: {pipe.topical_request_fraction:.1%}")

    # 3) every caching strategy of the paper at N entries: one CacheSpec per
    #    grid point, compiled to the reuse-distance engine
    n = args.entries
    print(f"\ncache size N={n}:")
    for strategy in STRATEGIES:
        best, best_cfg = 0.0, None
        for f_s in np.arange(0.1, 1.0, 0.2):
            for ft_frac, f_ts in ((0.8, 0.5), (0.5, 0.5)):
                spec = CacheSpec.from_strategy(strategy, n, f_s=f_s, f_t=ft_frac * (1 - f_s),
                                               f_ts=f_ts)
                hr = hit_rate(pipe.log, spec.to_layout(pipe.stats), device=args.device)
                if hr > best:
                    best = hr
                    best_cfg = (round(float(f_s), 1), round(float(ft_frac * (1 - f_s)), 2))
        print(f"  {strategy:13s} hit_rate={best:.4f}  (f_s, f_t)={best_cfg}")

    n_test = len(synth.keys) - pipe.log.n_train
    hits = belady_hits(synth.keys, n, count_from=pipe.log.n_train)
    print(f"  {'Belady bound':13s} hit_rate={hits / n_test:.4f}  ({hits} of {n_test} test "
          f"requests)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
