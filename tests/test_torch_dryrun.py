"""The port's dry-run: its roofline against the reference's, and cells
placed on the fake 512-rank production mesh.

``roofline`` is the reference's formula with the card's datasheet constants
as defaults; given the reference's TPU constants it returns the reference's
numbers.  Four cells (gemma-2b ``train_4k``, llama4-scout ``decode_32k``,
two-tower ``serve_bulk``, PNA ``ogb_products``) run through ``run_cell`` in a
subprocess (the fake process group must not share the test's process) on
(pod=2, data=16, model=16): each has status ``ok``, ran on meta, and its
per-device argument bytes equal a count by hand from the specs (each leaf's
bytes over the product of the axes its spec names), gemma-2b's ``embed``
among them: vocab x d_model x 2 B / 16.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

# lock the backend to the real device count BEFORE importing repro.launch.
# dryrun (whose module header sets XLA_FLAGS=...device_count=512)
jax.devices()

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("gemma-2b", "train_4k"), ("llama4-scout-17b-a16e", "decode_32k"),
         ("two-tower-retrieval", "serve_bulk"), ("pna", "ogb_products")]

SCRIPT = r'''
import json, sys
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step
from repro_torch.configs import get_arch
out = {"cells": [dryrun.run_cell(a, s, True, verbose=False) for a, s in json.loads(sys.argv[1])]}
mesh = make_production_mesh(multi_pod=True, device="cpu")
arch = get_arch("gemma-2b")
b = build_step(arch, arch.shape("train_4k"), mesh)
embed = b.place(*b.inputs)[0]["embed"]
out["embed"] = [list(embed.shape), embed.to_local().numel() * embed.element_size(), str(embed.placements)]
print(json.dumps(out, default=str))
'''


def test_roofline_equals_the_references():
    from repro.launch import dryrun as jdry
    from repro_torch.launch import dryrun as tdry

    cost = {"flops": 3.0e15, "bytes accessed": 2.0e11}
    coll = {"all-gather": 4.0e9, "all-reduce": 1.0e9, "reduce-scatter": 0, "all-to-all": 0,
            "collective-permute": 0, "counts": {}}
    for model_flops, chips in ((1.0e18, 256), (2.0e16, 512), (0.0, 4)):
        want = jdry.roofline(cost, coll, chips, model_flops)
        got = tdry.roofline(cost, coll, chips, model_flops, peak_flops=jdry.PEAK_FLOPS,
                            hbm_bw=jdry.HBM_BW, link_bw=jdry.ICI_BW)
        assert got == want
    assert tdry.roofline({}, coll, 4, 1.0)["useful_flops_ratio"] == 0.0
    # the defaults are the H100 datasheet's, no TPU figure
    rf = tdry.roofline({"flops": 989.4e12, "bytes accessed": 3.35e12}, dict(coll, **{
        "all-gather": 450e9, "all-reduce": 0}), 1, 989.4e12)
    assert rf["t_compute_s"] == rf["t_memory_s"] == rf["t_collective_s"] == 1.0


def _by_hand(arch_name, shape_name):
    """Σ over the placed inputs of leaf bytes / (product of its spec's axes)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.shardings import _axis_size
    from repro_torch.launch.steps import build_step
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import set_moe_mesh

    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    arch = get_arch(arch_name)
    try:
        bundle = build_step(arch, arch.shape(shape_name), mesh)
    finally:
        set_moe_mesh(None)
    total = 0
    for tree, sh in zip(bundle.inputs, bundle.in_shardings):
        for leaf, s in zip(tree_leaves(tree), tree_leaves_shardings(sh)):
            div = math.prod(_axis_size(mesh, a) for a in s.spec)
            assert leaf.numel() % div == 0
            total += leaf.numel() * leaf.element_size() // div
    return total


def tree_leaves_shardings(tree):
    from repro_torch.launch.shardings import NamedSharding

    if isinstance(tree, NamedSharding):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_shardings(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves_shardings(v)]
    return []


def test_cells_on_the_fake_512_rank_mesh():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(CELLS)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for cell, (arch, shape) in zip(res["cells"], CELLS):
        assert (cell["arch"], cell["shape"], cell["mesh"], cell["n_chips"]) == (
            arch, shape, "2x16x16", 512)
        assert cell["status"] == "ok" and "roofline" in cell, cell["status"]
        assert cell["memory"]["argument_bytes_per_device"] == _by_hand(arch, shape)
        assert not cell["memory"]["over_80gb"] and cell["model_flops"] > 0
        rf = cell["roofline"]
        assert rf["hlo_flops_per_device"] > 0 and rf["model_flops"] == cell["model_flops"]
    shape, local_bytes, placements = res["embed"]
    assert shape == [256000, 2048] and local_bytes == 256000 * 2048 * 2 // 16
    assert placements == "(Replicate(), Replicate(), Shard(dim=0))"
