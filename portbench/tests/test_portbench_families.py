"""Model families: the default family reads what the harness read before it
had families (the same layouts, FLOP counts, weight bits and reference
logits, recorded before the families came in), and a new family is only
new files: a family file, its configuration and its ``BENCHMARK.json``
entry."""
import hashlib
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from conftest import HERE, MODEL, MOE, REPO, config, load_harness, run

BF, F32 = torch.bfloat16, torch.float32
G, A = 4096**-0.5, 7168**-0.5

LAYOUTS = {
    "glm4-9b": [
        ("embed", (151552, 4096), 1.0, BF),
        ("layers.attn.q", (40, 4096, 4096), G, BF),
        ("layers.attn.k", (40, 4096, 256), G, BF),
        ("layers.attn.v", (40, 4096, 256), G, BF),
        ("layers.attn.o", (40, 4096, 4096), G, BF),
        ("layers.pre_attn_norm.scale", (40, 4096), 0.0, BF),
        ("layers.pre_mlp_norm.scale", (40, 4096), 0.0, BF),
        ("final_norm.scale", (4096,), 0.0, BF),
        ("lm_head", (4096, 151552), G, BF),
        ("layers.attn.q_bias", (40, 4096), 0.0, BF),
        ("layers.attn.k_bias", (40, 256), 0.0, BF),
        ("layers.attn.v_bias", (40, 256), 0.0, BF),
        ("layers.mlp.wi", (40, 4096, 27392), G, BF),
        ("layers.mlp.wo", (40, 13696, 4096), 13696**-0.5, BF)],
    "arctic-480b": [
        ("embed", (32000, 7168), 1.0, BF),
        ("layers.attn.q", (2, 7168, 7168), A, BF),
        ("layers.attn.k", (2, 7168, 1024), A, BF),
        ("layers.attn.v", (2, 7168, 1024), A, BF),
        ("layers.attn.o", (2, 7168, 7168), A, BF),
        ("layers.pre_attn_norm.scale", (2, 7168), 0.0, BF),
        ("layers.pre_mlp_norm.scale", (2, 7168), 0.0, BF),
        ("final_norm.scale", (7168,), 0.0, BF),
        ("lm_head", (7168, 32000), A, BF),
        ("layers.moe.router", (2, 7168, 128), A, F32),
        ("layers.moe.wi", (2, 128, 7168, 2, 4864), A, BF),
        ("layers.moe.wo", (2, 128, 4864, 7168), 4864**-0.5, BF),
        ("layers.mlp.wi", (2, 7168, 14336), A, BF),
        ("layers.mlp.wo", (2, 7168, 7168), A, BF)],
}
ROW_FLOPS = {"glm4-9b": 131_768_254_464, "arctic-480b": 15_872_819_200}

#: sha256 (first 16 hex digits) of each tensor's bits that ``weights.make``
#: drew from seed 1234 on the CPU before the families came in
ZEROS_2X64, ZEROS_64 = "5341e6b2646979a7", "38723a2e5e8a17aa"
SHARED = {"embed": "e7618bb214db59df", "layers.attn.q": "b25cbf6d40a26960",
          "layers.attn.k": "966c2a0f4c486951", "layers.attn.v": "162d9e7a2474e5cc",
          "layers.attn.o": "d9e17ad211a2ff05", "lm_head": "2bff213719c244e7",
          "layers.pre_attn_norm.scale": ZEROS_2X64, "layers.pre_mlp_norm.scale": ZEROS_2X64,
          "final_norm.scale": ZEROS_64}
WEIGHT_BITS = {
    "dense": dict(SHARED, **{"layers.mlp.wi": "a09ad020949fd3ff", "layers.mlp.wo": "430b0c5146b2af49",
                             "layers.attn.q_bias": ZEROS_2X64, "layers.attn.k_bias": ZEROS_64,
                             "layers.attn.v_bias": ZEROS_64}),
    "moe": dict(SHARED, **{"layers.moe.wi": "2b70dbc426cb9a2c", "layers.moe.wo": "46c1e309e7e9178d",
                           "layers.mlp.wi": "1f6ccc84ed5b378e", "layers.mlp.wo": "ff31598ebe5b122a",
                           "layers.moe.router": "08666532c1d47ecb"}),
}
#: the reference's last logits on 128 windows of those weights, recorded
#: before the families came in: rows 0, 32, 64, 96 at every 64th id.  They
#: are bf16 values, so a flipped rounding of the CPU's f32 sums moves one
#: by an ulp (0.0078-0.0156 at 1-4); the control's differ by 0.11 or more.
LOGITS = {
    ("dense", "bf16"): [
        -1.0234375, -0.78515625, -0.478515625, 0.283203125, 0.75, -0.049560546875, 0.1064453125,
        0.8984375, 1.484375, 0.9296875, 0.8125, -1.1484375, -0.42578125, -1.953125, -1.125,
        0.6484375, 0.82421875, 1.625, 0.41015625, -1.4296875, -0.97265625, 1.3359375, 0.9453125,
        0.146484375, -0.2236328125, 1.390625, 0.3046875, -0.16015625, 0.263671875, -0.89453125,
        -1.1171875, 0.6796875],
    ("dense", "fp8"): [
        -1.0234375, -0.77734375, -0.52734375, 0.1826171875, 0.71875, -0.01177978515625,
        0.1591796875, 0.9296875, 1.421875, 0.90234375, 0.82421875, -1.140625, -0.515625,
        -2.09375, -1.1875, 0.380859375, 0.7890625, 1.5078125, 0.390625, -1.390625, -0.9453125,
        1.3203125, 0.89453125, 0.11669921875, -0.30078125, 1.328125, 0.298828125,
        -0.0023040771484375, 0.302734375, -0.7421875, -1.1796875, 0.6171875],
    ("moe", "bf16"): [
        -0.1533203125, -1.5546875, -0.7890625, -1.0703125, 0.400390625, 0.875, 0.87109375,
        0.48046875, -0.6015625, 0.205078125, -0.330078125, -1.9453125, -0.68359375, -2.5625,
        0.796875, 0.06787109375, 1.125, 2.046875, 0.458984375, -1.453125, -0.8359375,
        0.376953125, 0.193359375, 0.95703125, -0.453125, 1.0625, -0.2236328125, -1.796875,
        0.07421875, -0.314453125, -1.2890625, 0.68359375],
    ("moe", "fp8"): [
        -0.1640625, -1.6875, -0.9296875, -1.0703125, 0.404296875, 0.98828125, 0.796875,
        0.53515625, -0.5859375, 0.265625, -0.337890625, -1.8984375, -0.71484375, -2.625,
        0.69140625, 0.0927734375, 1.1640625, 2.046875, 0.4921875, -1.5234375, -0.86328125,
        0.326171875, 0.1376953125, 0.8984375, -0.3671875, 1.140625, -0.17578125, -1.7265625,
        0.10546875, -0.22265625, -1.296875, 0.65625],
}
LOGIT_TOL = 0.02
SMOKE = {"dense": MODEL, "moe": MOE}


def _bits(t):
    t = t.detach().cpu().contiguous()
    v = t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)
    return hashlib.sha256(v.numpy().tobytes()).hexdigest()[:16]


def _model(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_default_family_layout_and_flops(name):
    h = load_harness(HERE.parent)
    import arith
    import refmodel
    import weights

    cfg = _model(name)
    fam = h.family(cfg)
    assert "family" not in cfg and fam.name == "default"
    assert (fam.program_config, fam.layout, fam.Reference, fam.row_flops) == (
        h.transformer_config, weights.layout, refmodel.Reference, arith.row_flops)
    assert fam.layout(cfg["model"]) == LAYOUTS[name]
    assert fam.row_flops(cfg["model"]) == ROW_FLOPS[name]
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.models import transformer as tf

    # the harness judges whole calls where the program's config has experts
    assert (fam.program_config(tf, cfg["model"]).moe is not None) == (name == "arctic-480b")


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_default_family_draws_and_judges_as_before(kind):
    h = load_harness(HERE.parent)
    import weights
    from stream import query_tokens

    fam, m = h.family({}), SMOKE[kind]
    w = weights.make(m, 1234, torch.device("cpu"), fam.layout)
    assert {k: _bits(v) for k, v in w.items()} == WEIGHT_BITS[kind]
    tokens = torch.from_numpy(query_tokens(np.arange(0, 6400, 50), 512))
    want = {mode: torch.tensor(LOGITS[kind, mode]).view(4, 8) for mode in ("bf16", "fp8")}
    assert (want["bf16"] - want["fp8"]).abs().max() > 5 * LOGIT_TOL
    for mode in ("bf16", "fp8"):
        got = fam.Reference(m, w, mode).last_logits(tokens)[::32, ::64]
        torch.testing.assert_close(got, want[mode], rtol=0, atol=LOGIT_TOL)


def _add_family(root, family, name="tinygeglu", reference_act=None):
    """``family`` (a file of ``tests/families``) copied into the checkout's
    ``families/``, a configuration that names it and a bulk cell in
    ``BENCHMARK.json``: new files and entries only.  ``reference_act``
    swaps the reference's activation, a family at fault.  The name starts
    with ``tiny`` so that the card test's longer stream reaches it."""
    src = (HERE / "tests" / "families" / f"{family}.py").read_text()
    if reference_act:
        src = src.replace('F.gelu(gate, approximate="tanh")', reference_act)
    fams = root / "portbench" / "families"
    fams.mkdir(exist_ok=True)
    (fams / f"{name}.py").write_text(src)
    (root / "portbench" / "configs" / f"{name}.json").write_text(
        json.dumps(dict(config(MODEL), family=name)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = f"{name}.bulk"
    bench["workloads"].append({"name": cell, "config": name, "traffic": "bulk", "chips": 1})
    bench["end_to_end"][0]["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


def test_a_new_family_is_only_new_files(root):
    cell = _add_family(root, "geglu")
    h = load_harness(root)
    _, _, cfg, _ = h.find_cell(root, cell)
    fam = h.family(cfg)
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.models import transformer as tf

    assert fam.name == "tinygeglu" and fam.program_config(tf, MODEL).activation == "gelu"
    assert h.transformer_config(tf, MODEL).activation == "silu"

    sound = run(root, cell)
    assert sound["correct"], sound["checks"]
    assert sound["checks"]["backend_gap"]["value"] < 0.05
    control = run(root, cell, control=True)
    assert not control["correct"], control["checks"]
    over = [k for k, v in control["checks"].items() if v["value"] > v["limit"]]
    assert over == ["backend_gap"]


def test_a_family_reference_at_fault_is_not_correct(root):
    """The program runs GeGLU, the family's reference SwiGLU."""
    cell = _add_family(root, "geglu", reference_act="F.silu(gate)")
    out = run(root, cell)
    assert not out["correct"], out["checks"]
    assert out["checks"]["backend_gap"]["value"] > out["checks"]["backend_gap"]["limit"]


def test_a_family_file_missing_or_short(root):
    h = load_harness(root)
    with pytest.raises(h.Fail, match="no model family 'nope'"):
        h.family({"family": "nope"})
    fams = root / "portbench" / "families"
    fams.mkdir(exist_ok=True)
    shutil.copy(HERE / "tests" / "families" / "geglu.py", fams / "tests_short.py")
    with open(fams / "tests_short.py", "a") as f:
        f.write("\ndel layout, row_flops\n")
    with pytest.raises(h.Fail, match="gives no layout, row_flops"):
        h.family({"family": "tests_short"})
