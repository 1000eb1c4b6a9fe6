"""The two readings a back-end limit is set from, on the card: each number
the configuration compares (``harness.gap_stat``) for the program over
many seeds (its sound runs' largest) and for the fp8 control on the same
rows (its smallest).  One process, each seed in turn: the seed's weights,
the CLI's back end with its CUDA graphs, calls of the sizes a window makes
over distinct query ids of the seed's stream, the reference and the
control over the same rows, each through the configuration's model family
(``harness.family``).  For the default family's expert model it also
reads a planted fault, the reference with one expert's output projection
negated in every layer put in the program's place, and how close to a tie
the routing of the rows the program answers off lies.

    python3 portbench/readings.py --workload glm4-9b.bulk --seeds 1,2,3 --rows 1000

Prints one line per seed and a summary (standard output).
"""
import argparse
import gc
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402
import weights as weights_mod  # noqa: E402
from refmodel import Reference  # noqa: E402
from stream import StreamConfig, draw_stream  # noqa: E402


#: the numbers a configuration may compare, read for every seed
STATS = ("backend_gap", "backend_gap_p90") + tuple(
    f"backend_rows_over_{t}" for t in (0.02, 0.04, 0.05, 0.1, 0.25))
#: the gap past which the margin look counts a row as answered off
LOOK_GAP = 0.25


def one_expert_negated(m, w):
    """The reference with expert 0's output projection negated in every
    layer (in place for the call, then restored: negation is exact)."""
    def logits(t):
        wo = w["layers.moe.wo"][:, 0]
        wo.neg_()
        try:
            return Reference(m, w).last_logits(t)
        finally:
            wo.neg_()
    return logits


def margin_look(run, m, w, dev, seed, gaps):
    """Whether the rows the program answers differently are the rows whose
    routing is close to a tie: for each sampled call's rows, the smallest
    margin of a routing choice that reaches the last position (every
    position in the first layer, the last position in the second)."""
    from stream import query_tokens
    import arith

    rng = np.random.default_rng([seed, 7])
    calls = run.backend_calls
    pick = rng.choice(len(calls), size=min(2, len(calls)), replace=False)
    mins = []
    for ci in pick:
        b = calls[int(ci)]
        n = len(b.qids)
        tok = np.zeros((arith.pow2(n), 8), np.int64)
        tok[:n] = query_tokens(b.qids, m["vocab_size"])
        ref = Reference(m, w)
        ref.margins = []
        ref.last_logits(torch.from_numpy(tok).to(dev))
        first = ref.margins[0][:n].amin(dim=1)
        last = torch.stack([mg[:n, -1] for mg in ref.margins[1:]], 1).amin(dim=1)
        mins.append(torch.minimum(first, last).cpu().numpy())
    mins = np.concatenate(mins)
    off = gaps > LOOK_GAP
    out = {}
    for th in (1e-4, 1e-3, 1e-2):
        out[f"off_rows_margin_under_{th}"] = float((mins[off] < th).mean()) if off.any() else None
        out[f"other_rows_margin_under_{th}"] = float((mins[~off] < th).mean())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(prog="portbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rows", type=int, required=True, help="ids in each back-end call")
    ap.add_argument("--calls", type=int, default=4, help="calls per seed")
    args = ap.parse_args()
    root = Path.cwd()
    _, cell, cfg, mix = harness.find_cell(root, args.workload)
    sys.path.insert(0, str(root / "src"))
    from repro_torch.launch.serve import lm_backend
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    m, c = cfg["model"], cfg["cache"]
    fam = harness.family(cfg)
    mcfg = fam.program_config(tf, m)
    # an expert layer's rows are judged in whole calls, as the harness judges
    # them; the planted fault and the margin look read the default family's
    # expert weights and its reference's routing margins
    whole_calls = mcfg.moe is not None
    expert_look = fam.name == "default" and whole_calls
    batch = int(mix["batch"])
    res = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        keys, _ = draw_stream(StreamConfig.scaled(0.1, seed))
        w = weights_mod.make(m, seed, dev, fam.layout)
        backend = lm_backend(tf.ParamTree(weights_mod.tree(w)), mcfg,
                             c["value_dim"], device=dev,
                             graph_max=min(batch, 1 << (args.rows - 1).bit_length()))
        ids = np.unique(keys)
        np.random.default_rng(seed).shuffle(ids)
        calls = [SimpleNamespace(qids=np.sort(ids[i * args.rows:(i + 1) * args.rows]))
                 for i in range(args.calls)]
        for b in calls:
            b.out = backend(b.qids)
        del backend
        gc.collect()
        torch.cuda.empty_cache()
        run = SimpleNamespace(backend_calls=calls, mix=mix, family=fam, whole_calls=whole_calls)
        stand_ins = {"control": fam.Reference(m, w, "fp8").last_logits}
        if expert_look:
            stand_ins["one_expert"] = one_expert_negated(m, w)
        gaps, others = harness.backend_gap(run, m, w, dev, seed, c["value_dim"],
                                           tuple(stand_ins.values()))
        line = {"seed": seed, "rows": len(gaps)}
        for who, g in zip(["program", *stand_ins], [gaps, *others]):
            line[who] = {name: harness.gap_stat(name, g) for name in STATS}
            line[who].update(p50=float(np.median(g)), p99=float(np.percentile(g, 99)))
        if expert_look:
            line["margins"] = margin_look(run, m, w, dev, seed, gaps)
        res.append(line)
        print(json.dumps(line), flush=True)
        del w, calls, run, stand_ins, others
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "rows": args.rows}
    for name in STATS:
        summary[f"program_{name}_largest"] = max(r["program"][name] for r in res)
        for who in res[0]:
            if who in ("control", "one_expert"):
                summary[f"{who}_{name}_smallest"] = min(r[who][name] for r in res)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
