"""Nothing the command runs imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
references import nothing of the program."""
import ast
import json
import subprocess
import sys

from conftest import HERE

REFERENCE = ("refcache.py", "refmodel.py", "stream.py", "arith.py", "weights.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_references_import_nothing_of_the_program():
    for name in REFERENCE:
        assert not _imports(HERE / name) & {"repro", "repro_torch", "jax", "jaxlib", "flax"}, name


def test_no_source_imports_jax():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & {"repro", "jax", "jaxlib", "flax"}, path


def test_check_modules_compares_whole_names():
    import harness
    assert harness.check_modules(["repro_torch.serving", "repro_torch", "numpy"]) == []
    assert harness.check_modules(["repro.core.spec", "jaxlib.xla", "torch"]) == ["jaxlib", "repro"]
    assert harness.check_modules(["flax", "jax"]) == ["flax", "jax"]


def test_a_run_loads_no_jax(root):
    code = (
        "import sys, time, json; sys.path.insert(0, 'portbench'); import harness; "
        "from pathlib import Path; "
        "out = harness.run_cell(Path('.'), 'tiny.bulk', 3, 0.5, False, time.perf_counter(), "
        "device='cpu'); "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_no_program_no_result(root, tmp_path):
    # a directory with only BENCHMARK.json and the benchmark's files
    (root / "src").unlink()
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tiny.bulk",
                          "--seed", "1", "--seconds", "1"], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
