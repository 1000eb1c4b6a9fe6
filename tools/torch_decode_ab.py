"""Host-clock time of the port's gemma-2b decode step, for comparing two
trees of the repository on one card in one call.

    python tools/torch_decode_ab.py TREE [TREE ...]

Each TREE is a checkout's root (its ``src/`` holds ``repro_torch``); each
runs in a fresh process, in the order given (run a parent and a change as
``parent change change parent``).  Per tree: gemma-2b at full width
(random weights from a seed), a bf16 KV cache of batch 64 x 4096 slots
filled with noise, 8 warm-up steps, then three repetitions of 64 decode
steps, each printed as ms per step on the host clock after
``torch.cuda.synchronize()`` and ms per step to enqueue them.  Needs one
CUDA card.
"""
import subprocess
import sys
import time


def run_tree(root: str) -> None:
    sys.path.insert(0, root + "/src")
    import torch

    from repro_torch.configs import gemma_2b
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda")
    cfg = gemma_2b.CONFIG
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    b, s = 64, 4096
    cache = tf.init_cache(cfg, b, s, device=dev)
    cache["k"].normal_()
    cache["v"].normal_()
    tok = torch.randint(0, cfg.vocab_size, (b, 1), device=dev)
    res = []
    for _ in range(3):
        cache["len"].fill_(s - 80)
        for _ in range(8):
            _, cache = tf.decode_step(params, cache, tok, cfg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(64):
            _, cache = tf.decode_step(params, cache, tok, cfg)
        enqueue = (time.perf_counter() - t) / 64
        torch.cuda.synchronize()
        res.append(((time.perf_counter() - t) / 64 * 1e3, enqueue * 1e3))
    print(root, " ".join(f"{a:.3f}/{e:.3f}" for a, e in res),
          "ms/step (host clock / enqueue)", flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_tree(sys.argv[2])
        return 0
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
