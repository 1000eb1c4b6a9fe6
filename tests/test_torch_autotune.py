"""The port's autotune table (``repro_torch.serving.autotune``) against the
reference's: the same names and constants, tables written by either
package read by the other, ``best_bm``'s exact, nearest-larger and default
answers, a corrupt or foreign-schema file, the memo and
``REPRO_AUTOTUNE_PATH``."""
import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.serving import autotune as ref  # noqa: E402
from repro_torch.serving import autotune as port  # noqa: E402

TABLE = {
    "roofline_bytes_per_s": 1.2e10,
    "entries": {
        "cuda/256": {"bm": 64, "us_per_call": 20.5, "bytes_per_s": 3e9, "frac": 0.25},
        "cuda/4096": {"bm": 512, "us_per_call": 812.4, "bytes_per_s": 9.1e9, "frac": 0.76},
        "cpu/1024": {"bm": 128, "us_per_call": 90.0, "bytes_per_s": 1e9, "frac": 0.1},
        "cuda/oops": {"bm": 8},
        "cuda/8192": {"us_per_call": 1.0},
    },
}
#: (backend, bucket) -> the tuned bm both packages give
ASKS = {("cuda", 256): 64, ("cuda", 4096): 512, ("cuda", 300): 512, ("cuda", 1): 64,
        ("cuda", 5000): ref.DEFAULT_BM, ("cpu", 1024): 128, ("cpu", 512): 128,
        ("cpu", 2048): ref.DEFAULT_BM, ("gpu", 256): ref.DEFAULT_BM}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv(ref.ENV_PATH, raising=False)
    ref.clear_cache()
    port.clear_cache()
    yield
    ref.clear_cache()
    port.clear_cache()


def test_the_names_and_constants_are_the_references():
    assert port.__all__ == ref.__all__
    for name in ("AUTOTUNE_SCHEMA", "DEFAULT_BM", "DEFAULT_PATH", "ENV_PATH"):
        assert getattr(port, name) == getattr(ref, name)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_table_written_by_either_package_reads_in_both(tmp_path, writer):
    path = str(tmp_path / "autotune.json")
    (ref if writer == "reference" else port).save_table(TABLE, path)
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk == dict(TABLE, schema=ref.AUTOTUNE_SCHEMA)
    assert port.load_table(path) == ref.load_table(path) == on_disk
    for (backend, bucket), bm in ASKS.items():
        assert port.best_bm(backend, bucket, path) == ref.best_bm(backend, bucket, path) == bm


def test_the_files_are_byte_equal(tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    ref.save_table(TABLE, a)
    port.save_table(TABLE, b)
    assert open(a).read() == open(b).read()


@pytest.mark.parametrize("content", ["{not json", json.dumps({"schema": 2, "entries": {}}),
                                     json.dumps([1, 2]), None])
def test_a_missing_corrupt_or_foreign_table_falls_back_to_the_default(tmp_path, content):
    path = tmp_path / "autotune.json"
    if content is not None:
        path.write_text(content)
    assert port.load_table(str(path)) is None
    assert port.best_bm("cuda", 4096, str(path)) == ref.best_bm("cuda", 4096, str(path)) \
        == port.DEFAULT_BM


def test_the_env_path_and_the_memo(tmp_path, monkeypatch):
    path = str(tmp_path / "env.json")
    monkeypatch.setenv(port.ENV_PATH, path)
    assert port.table_path() == ref.table_path() == path
    assert port.best_bm("cuda", 4096) == port.DEFAULT_BM  # no file yet; memoized as None
    with open(path, "w") as f:
        json.dump(dict(TABLE, schema=1), f)
    assert port.best_bm("cuda", 4096) == port.DEFAULT_BM  # the memo holds
    port.clear_cache()
    assert port.best_bm("cuda", 4096) == ref.best_bm("cuda", 4096) == 512
    assert port.save_table({"entries": {"cuda/4096": {"bm": 32}}}) == path
    assert port.best_bm("cuda", 4096) == 32  # saving drops the memo
    monkeypatch.delenv(port.ENV_PATH)
    assert port.table_path() == port.DEFAULT_PATH
