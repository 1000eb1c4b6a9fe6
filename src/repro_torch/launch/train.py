"""Training CLI: the port of ``repro.launch.train``, an end-to-end loop
with fault tolerance, on the card unless told otherwise.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
      --steps 200 --ckpt-dir /tmp/ckpt [--resume] [--kill-at 120] \
      [--device cpu]

The reference's flags and lines (``step N loss X``, ``resumed from step
N``, ``simulating node failure at step N``, ``done``), on the LM family's
smoke config.  ``--kill-at`` simulates a node failure at a step (the
process exits 42 mid-run); re-launching with ``--resume`` continues from
the last good checkpoint.  Checkpoints are the reference's format
(``repro_torch.train.checkpoint``: ``params/...``, ``opt/.step``,
``opt/.mu/...``, ``opt/.nu/...``), so either package's CLI resumes the
other's.  The weights start from a seeded ``torch.Generator``, not the
reference's ``jax.random`` draw.

On the card the steps are deterministic, so a resumed run ends bit-equal
to an uninterrupted one: ``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (set here when the environment has
none, before CUDA starts; cuBLAS needs it for deterministic results).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from ..configs.registry import get_arch
from ..core.device import resolve_device
from ..models import transformer as tf
from ..train import AdamWConfig, SyntheticLM, apply_updates, init_opt_state, latest_step, restore, save
from ..train.optim import opt_state_from_numpy
from .steps import value_and_grad

def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-at", type=int, default=0, help="simulate failure")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit("the training CLI trains the LM family only")
    cfg = arch.smoke_config
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)

    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20)
    opt = init_opt_state(params)
    data = SyntheticLM(cfg.vocab_size, args.seq_len, args.batch, seed=0)
    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        tree, start = restore(args.ckpt_dir, {"params": params.tree(), "opt": opt})
        params = tf.params_from_numpy(tree["params"], dev)
        opt = opt_state_from_numpy(tree["opt"], dev)
        start += 1
        print(f"resumed from step {start - 1}")

    grad_fn = value_and_grad(tf.loss_fn)

    def train_step(params, opt, batch):
        loss, grads = grad_fn(params, batch, cfg)
        params, opt = apply_updates(params, grads, opt, opt_cfg)
        return params, opt, loss

    t0 = time.time()
    for step in range(start, args.steps):
        batch = {"tokens": torch.from_numpy(data.batch(step)["tokens"]).to(dev)}
        params, opt, loss = train_step(params, opt, batch)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(loss):.4f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            save(args.ckpt_dir, step, {"params": params.tree(), "opt": opt})
        if args.kill_at and step == args.kill_at:
            print(f"simulating node failure at step {step}", flush=True)
            sys.exit(42)
    save(args.ckpt_dir, args.steps - 1, {"params": params.tree(), "opt": opt})
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
