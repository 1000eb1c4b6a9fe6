"""Multi-pod dry-run of the port: every (arch x shape) cell placed on the
production mesh of a fake process group, with no device and no bytes.

The process sets up a world of 256 ranks (the single-pod mesh, data=16 x
model=16) or 512 (pod=2 x data=16 x model=16) on ``FakeStore``, rank 0 of
it, and builds the mesh on the ``cpu`` device type; every tensor is on
``meta``.  For each cell it builds the :class:`~repro_torch.launch.steps.
StepBundle`, places every input (parameters, optimizer state, batch, KV
cache) by its shardings -- each sharded dim must divide -- and reports the
per-device argument bytes (the sum of rank 0's blocks; every rank's are
alike), flagging a cell over the card's 80 GB, and ``model_flops``.  It
then runs the step on the placed meta DTensors under a flop counter and a
record of the functional collectives: the flops per device and the
collectives by kind, with counts and bytes (each op's result, as the
reference counts HLO results).  A step that does not run on meta keeps its
placement numbers, and its ``status`` says why the rest is missing.

This checks placements, bytes and flops.  It compiles nothing and times
nothing: XLA's ``memory_analysis``/``cost_analysis``, the HLO parser and the
scan correction of the reference read a compiled module, which torch does
not build.  The roofline's constants are the datasheet's (below), not a
measurement.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--json out.json]

The cells run in worker processes side by side (half the host's cores),
each holding one mesh's fake world and a share of its cells.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.registry import all_cells, get_arch
from ..models.common import tree_leaves
from .mesh import make_production_mesh, mesh_device_count
from .steps import build_step

# ---------------------------------------------------------------------------
# Hardware model: one NVIDIA H100 80GB HBM3 (SXM, 700 W), datasheet figures
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989.4e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # NVLink bytes/s per direction
HBM_BYTES = 80e9  # the card's memory, for the over-80-GB flag

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def roofline(cost: dict, coll: dict, n_chips: int, model_flops: float,
             peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
             link_bw: float = LINK_BW) -> dict:
    """The reference's roofline terms: ``cost`` and ``coll`` are per-device
    quantities, ``model_flops`` the global analytic count."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    coll_bytes = sum(v for k, v in coll.items() if k != "counts")
    t_compute = flops / peak_flops
    t_memory = bytes_accessed / hbm_bw
    t_collective = coll_bytes / link_bw
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    t_bound = max(t_compute, t_memory, t_collective)
    useful = model_flops / (flops * n_chips) if flops else 0.0
    # roofline fraction: useful model FLOP/s at the bound vs chip peak
    mfu_bound = (model_flops / (n_chips * peak_flops)) / t_bound if t_bound else 0.0
    return {
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": coll_bytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "model_flops": model_flops,
        "useful_flops_ratio": useful,
        "roofline_fraction": mfu_bound,
        "collectives": coll,
    }


class CollectiveBytes(TorchDispatchMode):
    """Counts the functional collectives a step issues, by kind, with the
    bytes of each op's result (an all-gather's gathered size, a
    reduce-scatter's scattered size)."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(KINDS, 0)
        self.counts = dict.fromkeys(KINDS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _FUNCTIONAL.get(func.overloadpacket.__name__)
        if kind is not None and func.namespace == "_c10d_functional":
            self.counts[kind] += 1
            self.bytes[kind] += sum(t.numel() * t.element_size() for t in tree_leaves(out)
                                    if isinstance(t, torch.Tensor))
        return out

    def result(self) -> dict:
        return {**self.bytes, "counts": dict(self.counts)}


def fake_world(n_ranks: int) -> None:
    """This process as rank 0 of a fake world of ``n_ranks`` (collectives
    return at once and move nothing); an earlier world is torn down."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n_ranks:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)


def _local_bytes(tree) -> int:
    return sum((t.to_local() if hasattr(t, "to_local") else t).numel() * t.element_size()
               for t in tree_leaves(tree))


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, verbose: bool = True) -> dict:
    arch = get_arch(arch_name)
    shape = arch.shape(shape_name)
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    n_chips = mesh_device_count(mesh)
    t0 = time.time()
    bundle = build_step(arch, shape, mesh)
    placed = bundle.place(*bundle.inputs)
    per_device = _local_bytes(placed)
    result = {
        "arch": arch_name,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "n_chips": n_chips,
        "place_s": round(time.time() - t0, 3),
        "memory": {
            "argument_bytes_per_device": per_device,
            "argument_gb_per_device": round(per_device / 1e9, 3),
            "over_80gb": per_device > HBM_BYTES,
        },
        "model_flops": bundle.model_flops,
        "status": "ok",
    }
    from torch.utils.flop_counter import FlopCounterMode

    t1 = time.time()
    try:
        coll = CollectiveBytes()
        with FlopCounterMode(display=False) as flops, coll:
            bundle.fn(*placed)
        result["run_s"] = round(time.time() - t1, 3)
        result["roofline"] = roofline({"flops": float(flops.get_total_flops())}, coll.result(),
                                      n_chips, bundle.model_flops)
    except Exception as e:  # noqa: BLE001 -- the reason goes in the cell's status
        result["status"] = f"ok: placed; the step does not run on meta ({type(e).__name__}: {e})"
    if verbose:
        mem = result["memory"]
        print(f"== {bundle.name} on {result['mesh']} ({n_chips} ranks) ==")
        print(f"  argument bytes per device {mem['argument_bytes_per_device']} "
              f"({mem['argument_gb_per_device']} GB){'  OVER 80 GB' if mem['over_80gb'] else ''}")
        print(f"  model_flops={bundle.model_flops:.3e}")
        if "roofline" in result:
            rf = result["roofline"]
            print(f"  flops per device={rf['hlo_flops_per_device']:.3e} "
                  f"useful_ratio={rf['useful_flops_ratio']:.3f} "
                  f"collective bytes per device={rf['collective_bytes_per_device']:.3e}")
            print(f"  collectives: {rf['collectives']}")
        else:
            print(f"  {result['status']}")
    return result


def _run_mesh(cells, multi_pod: bool, quiet: bool) -> list:
    """Every cell on one production mesh, in this process's fake world."""
    results = []
    for arch_name, shape_name in cells:
        try:
            r = run_cell(arch_name, shape_name, multi_pod, verbose=not quiet)
            if quiet:
                print(f"{arch_name}:{shape_name} {r['mesh']} "
                      f"{r['memory']['argument_gb_per_device']} GB/device "
                      f"{'run' if 'roofline' in r else 'placed'}", flush=True)
            results.append(r)
        except Exception as e:  # noqa: BLE001 -- a failed cell is reported, the rest run
            traceback.print_exc()
            results.append({"arch": arch_name, "shape": shape_name,
                            "mesh": "2x16x16" if multi_pod else "16x16",
                            "status": f"FAIL: {type(e).__name__}: {e}"})
            print(f"!! FAILED {arch_name}:{shape_name} multi_pod={multi_pod}: {e}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", help="write results JSON here")
    ap.add_argument("--quiet", action="store_true", help="one line per cell")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a.name, s.name) for a, s in all_cells()]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        arch = get_arch(args.arch)
        cells = [(arch.name, s.name) for s in arch.shapes]
    else:
        ap.error("need --arch [--shape] or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    # each process holds one fake world (one mesh) and runs every k-th of its
    # cells; half the host's cores take a share, the rest stay the caller's
    per_mesh = max(1, min(len(cells), (os.cpu_count() or 2) // (2 * len(meshes))))
    jobs = [(cells[i::per_mesh], mp) for mp in meshes for i in range(per_mesh)]
    if len(jobs) > 1:
        import concurrent.futures
        import multiprocessing

        with concurrent.futures.ProcessPoolExecutor(
                len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
            done = list(pool.map(_run_mesh, *zip(*jobs), [args.quiet] * len(jobs)))
    else:
        done = [_run_mesh(cells, meshes[0], args.quiet)]
    # back in the order of the cells, mesh by mesh
    order = {(mp, a, sh): i for i, (mp, (a, sh)) in enumerate(
        (mp, c) for mp in meshes for c in cells)}
    runs = [sorted((r for run in done for r in run),
                   key=lambda r: order[(r["mesh"] == "2x16x16", r["arch"], r["shape"])])]
    results = [r for run in runs for r in run]
    failed = sum(r["status"].startswith("FAIL") for r in results)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2, default=str)
        print(f"wrote {args.json}")
    print(f"{len(results) - failed}/{len(results)} cells passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
