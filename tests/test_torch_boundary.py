"""The port imports nothing of JAX and nothing of the JAX package.

``repro_torch`` keeps its own copies of what it needs (even of ``repro``'s
jax-free modules), and ``chip_smoke.py`` follows the same rule: the
machine with the card has no JAX.  And the port exports what the JAX
package exports: every name of each reference module's ``__all__`` is in
its port counterpart, but for the parts still to port.
"""
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_IMPORT = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro[ .])")


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.freshness\n"
        "import repro_torch.kernels._build, repro_torch.kernels.cache_ops\n"
        "import repro_torch.serving, repro_torch.querylog\n"
        "import repro_torch.topics, repro_torch.kernels.topic_score, repro_torch.core.fast\n"
        "import repro_torch.kernels.decode_attention, repro_torch.models.common\n"
        "import repro_torch.models.transformer, repro_torch.configs, repro_torch.configs.gemma_2b\n"
        "import repro_torch.launch.serve, repro_torch.launch.steps\n"
        "import repro_torch.kernels.embedding_bag, repro_torch.models.recsys\n"
        "import repro_torch.configs.two_tower_retrieval, repro_torch.configs.sasrec\n"
        "import repro_torch.configs.din, repro_torch.configs.mind\n"
        "import repro_torch.core.spec, repro_torch.core.alloc, repro_torch.train\n"
        "import repro_torch.train.checkpoint, repro_torch.serving.spec\n"
        "import repro_torch.serving.rebalance, repro_torch.serving.resilience\n"
        "import repro_torch.serving.cluster, repro_torch.loadgen, repro_torch.loadgen.arrivals\n"
        "import repro_torch.loadgen.harness, repro_torch.loadgen.inject, repro_torch.loadgen.slo\n"
        "import repro_torch.launch, repro_torch.launch.mesh\n"
        "import repro_torch.core.rd_offline, repro_torch.core.torch_sim, repro_torch.core.stats\n"
        "import repro_torch.core.policies, repro_torch.core.build, repro_torch.core.simulate\n"
        "import repro_torch.core.belady, repro_torch.querylog.parse\n"
        "import repro_torch.train.optim, repro_torch.train.data, repro_torch.launch.train\n"
        "from repro_torch.train import AdamWConfig, SyntheticLM, apply_updates\n"
        "from repro_torch.launch.steps import build_lm_step, value_and_grad\n"
        "from repro_torch.launch.serve import main\n"
        "import repro_torch.models.gnn, repro_torch.configs.pna\n"
        "import repro_torch.configs.gemma2_27b, repro_torch.configs.glm4_9b\n"
        "import repro_torch.configs.llama4_scout_17b_a16e, repro_torch.configs.arctic_480b\n"
        "import repro_torch.serving.autotune\n"
        "from repro_torch.models.common import top_k_ids\n"
        "from repro_torch.models.transformer import set_moe_mesh, get_moe_mesh\n"
        "import repro_torch.kernels.cache_ops.oracle, repro_torch.models\n"
        "from repro_torch.kernels import decode_attention_op, embedding_bag_op\n"
        "from repro_torch.kernels import probe_and_commit_op, topic_score_op\n"
        "from repro_torch.kernels.cache_ops import probe_and_commit_ref, serve_fused_ref\n"
        "from repro_torch.kernels.cache_ops import resolve_conflicts\n"
        "from repro_torch.launch.steps import build_gnn_step\n"
        "import repro_torch.launch.shardings, repro_torch.launch.dryrun, repro_torch.models.spmd\n"
        "from repro_torch.launch import StepBundle, build_step, input_specs\n"
        "from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh\n"
        "from repro_torch.configs import all_cells\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_import_line_names_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not _IMPORT.match(line), f"{path.relative_to(ROOT)}:{n}: {line}"


#: what stays unported: nothing (the mesh, the shardings, the step bundles
#: and the dry-run were the last)
NOT_YET = {}


def test_the_port_exports_every_name_of_the_references_all():
    """Each module of ``repro`` with an ``__all__`` (found in the source,
    so no module is imported for its side effects) against its port
    counterpart: the names missing are exactly ``NOT_YET``'s."""
    pytest.importorskip("jax")
    missing = {}
    for path in sorted((ROOT / "src" / "repro").rglob("*.py")):
        if not re.search(r"^__all__\s*=", path.read_text(), re.M):
            continue
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        name = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        ref = importlib.import_module(name)
        port_name = "repro_torch" + name[len("repro"):]
        try:
            port = importlib.import_module(port_name)
        except ModuleNotFoundError:
            missing[port_name] = {"*"}
            continue
        gone = {n for n in ref.__all__ if not hasattr(port, n)}
        if gone:
            missing[port_name] = gone
    assert missing == NOT_YET
