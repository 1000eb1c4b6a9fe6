"""The port imports nothing of JAX and nothing of the JAX package.

``repro_torch`` keeps its own copies of what it needs (even of ``repro``'s
jax-free modules), and ``chip_smoke.py`` follows the same rule: the
machine with the card has no JAX.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

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
        "from repro_torch.launch.serve import main\n"
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
