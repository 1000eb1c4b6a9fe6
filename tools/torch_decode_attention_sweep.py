"""Device time of the port's bf16 ``decode_attention`` kernel at the
registry LMs' decode geometries, beside ``scaled_dot_product_attention``
and the byte bound, for comparing trees and ring sizes on one card in one
call.

    python tools/torch_decode_attention_sweep.py [--diagnose] [--variant NAME=VALUE[,...] ...] TREE ...

Each TREE is a checkout's root (its ``src/`` holds ``repro_torch``); each
runs in a fresh process, in the order given (run a parent and a change as
``parent change change parent``).  Per tree and geometry: the kernel
against its plain version (one bf16 ulp plus 1e-5 of the largest output,
as ``chip_smoke.py`` holds it), then its mean device time over 20 launches
(CUDA events; a 256 MiB write flushes the L2 before each) and, from a
torch profiler window of 10 launches, the mean device time of each kernel
it launches (the main kernel and the merge, which runs as a programmatic
dependent launch, so its span starts with the main kernel's); with
``--variant``, once for each variant, a variant setting constants of the
tree's wrapper (``repro_torch.kernels.decode_attention.kernel``, e.g.
``STAGE_BYTES=32768``) and skipped where the tree lacks one.  Then SDPA
with ``enable_gqa`` over the kept keys copied head-major before timing (no
softcap: SDPA has none), its kernels split out the same way, and the byte
bound (the kept K and V rows, q and the output at 3.35 TB/s).  K and V
are drawn from a seed at S = 32768.  ``--diagnose`` runs the geometries of
``DIAGNOSE`` instead.  Needs one CUDA card.
"""
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
S = 32768
#: name, B, Hkv, G, d, cur, softcap, window, window_slice
GEOMETRIES = [
    ("gemma-2b", 64, 1, 8, 256, S - 1, None, None, None),
    ("llama4-scout", 16, 8, 5, 128, S - 16, None, None, None),
    ("arctic", 16, 8, 7, 128, S - 16, None, None, None),
    ("glm4-9b", 8, 2, 16, 128, S - 16, None, None, None),
    ("gemma2-27b slice", 2, 16, 2, 128, S - 16, 50.0, None, 4096),
    ("gemma2-27b window", 2, 16, 2, 128, S - 16, 50.0, 4096, None),
]
#: with ``--diagnose``: glm4-9b's read with its heads contiguous (Hkv 1),
#: with a narrower group (G 8) and doubled, and llama4-scout's width at the
#: doubled read's bytes with and without strided heads
DIAGNOSE = [
    ("glm4 B8 Hkv2 G16", 8, 2, 16, 128, S - 16, None, None, None),
    ("B16 Hkv1 G16", 16, 1, 16, 128, S - 16, None, None, None),
    ("B8 Hkv2 G8", 8, 2, 8, 128, S - 16, None, None, None),
    ("B16 Hkv2 G16", 16, 2, 16, 128, S - 16, None, None, None),
    ("B4 Hkv8 G5", 4, 8, 5, 128, S - 16, None, None, None),
    ("B32 Hkv1 G5", 32, 1, 5, 128, S - 16, None, None, None),
]


def time_device(torch, fn, flush, n=20) -> float:
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / n


def kernel_split(torch, fn, flush, n=10) -> str:
    """Mean device time of each kernel ``fn`` launches, from the torch
    profiler (the flush's elementwise kernel left out)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    parts = [f"{e.key[:40]} {e.device_time_total / n / 1e3:.6f} ms"
             for e in prof.key_averages()
             if e.device_time_total > 0 and "elementwise" not in e.key]
    return ", ".join(parts) or "no device time recorded"


def run_tree(root: str, variants, geometries) -> None:
    sys.path.insert(0, root + "/src")
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain

    dev = torch.device("cuda")
    flush = torch.empty(1 << 26, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    defaults = {name: getattr(dak, name) for v in variants for name in v if hasattr(dak, name)}
    variants = [v for v in variants if all(hasattr(dak, name) for name in v)] or [{}]
    for name, b, hkv, g, d, cur, cap, win, sl in geometries:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((b, hkv, g, d), (b, S, hkv, d), (b, S, hkv, d)))
        c = torch.tensor(cur, dtype=torch.int32, device=dev)
        scale = d**-0.5
        w = win or sl
        lo = max(0, cur - w + 1) if w else 0
        n_keys = min(cur, S - 1) - lo + 1
        nb = 2 * b * n_keys * hkv * d * 2 + 2 * q.numel() * 2
        line = [f"{root} {name} (B={b} Hkv={hkv} G={g} d={d} keys={n_keys}):"]
        want = decode_attention_plain(q, k, v, c, scale, cap, win, sl).float()
        bound = 2.0**-7 * want.abs() + 1e-5 * float(want.abs().max())
        for variant in variants:
            for key, value in {**defaults, **variant}.items():
                setattr(dak, key, type(defaults[key])(int(value)))
            run = lambda: dak.decode_attention(q, k, v, c, scale, cap, win, sl)  # noqa: E731
            ratio = float(((run().float() - want).abs() / bound).max())
            ms = time_device(torch, run, flush)
            tag = "".join(f" {key}={value}" for key, value in variant.items())
            line.append(f"kernel{tag} {ms:.6f} ms ({nb / ms / 1e6:.1f} GB/s, {ratio:.4f} of the "
                        f"bound to plain; {kernel_split(torch, run, flush)})")
        del want, bound
        qs = q.reshape(b, hkv * g, 1, d)
        ks = k[:, lo:lo + n_keys].permute(0, 2, 1, 3).contiguous()
        vs = v[:, lo:lo + n_keys].permute(0, 2, 1, 3).contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, scale=scale, enable_gqa=True)
        lib = time_device(torch, sdpa, flush)
        line.append(f"SDPA {lib:.6f} ms ({kernel_split(torch, sdpa, flush)}); byte bound "
                    f"{nb / HBM_BYTES_PER_S * 1e3:.6f} ms")
        print("; ".join(line), flush=True)
        del q, k, v, ks, vs, qs
        torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    variants, extra = [], []
    while args and args[0] in ("--variant", "--diagnose"):
        if args[0] == "--diagnose":
            extra.append(args.pop(0))
            continue
        variants.append(dict(kv.split("=") for kv in args[1].split(",")))
        extra += args[:2]
        args = args[2:]
    if args and args[0] == "--one":
        run_tree(args[1], variants, DIAGNOSE if "--diagnose" in extra else GEOMETRIES)
        return 0
    for root in args:
        subprocess.run([sys.executable, __file__, *extra, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
