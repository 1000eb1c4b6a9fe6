"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload glm4-9b.poisson --seed 7 --seconds 30 --trace 0

From the root of a checkout: the cell comes from ``BENCHMARK.json``, the
program from ``src/repro_torch``.  The last line of standard output is the
result, one JSON object; the numbers compared to decide ``correct`` close
standard error, each beside its limit.  The run fails (exit 1, no result)
without the CUDA devices the cell asks for, without the program, or when
JAX or the JAX package got loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the fp8 reference's ids in the back end's place: the "
                         "control, which must come out not correct")
    args = ap.parse_args(argv)
    # caches and builds stay inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(HERE))
    import harness

    try:
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                               T_START, control=bool(args.control))
    except harness.Fail as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
