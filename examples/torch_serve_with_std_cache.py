"""End-to-end serving on the port: a sharded STD cache cluster fronting a
transformer, on the card.

The paper's Fig. 2 as runnable code: the serving CLI
(``repro_torch.launch.serve``) compiles a ``ServingSpec`` into broker
shards over the device-resident topic-partitioned cache, with LDA topic
routing, hedged dispatch and manifest-verified checkpoints.
``examples/serve_with_std_cache.py`` on ``repro_torch``.

  PYTHONPATH=src python examples/torch_serve_with_std_cache.py [--device cpu]
"""
import argparse
import sys

from repro_torch.launch.serve import main as serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=30_000)
    ap.add_argument("--entries", type=int, default=2048)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the cache and the back end run (default: the card)")
    args = ap.parse_args(argv)
    return serve(["--requests", str(args.requests), "--entries", str(args.entries),
                  "--shards", str(args.shards), "--device", args.device])


if __name__ == "__main__":
    sys.exit(main())
