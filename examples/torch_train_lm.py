"""Train a reduced-config LM on the port for a few hundred steps with
checkpointing, on the card.

Exercises the training substrate end to end (AdamW, the data pipeline,
atomic checkpoints) through ``repro_torch.launch.train``.  Loss should drop
by >0.5 nats over the run.  ``examples/train_lm.py`` on ``repro_torch``.

  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch.train import main as train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt_ex"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)
    return train(["--arch", "gemma-2b", "--steps", str(args.steps), "--ckpt-dir", args.ckpt_dir,
                  "--device", args.device])


if __name__ == "__main__":
    sys.exit(main())
