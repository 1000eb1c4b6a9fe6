"""Checkpoints across the two packages, on the CPU.

The port's ``repro_torch.train.checkpoint`` writes the reference's format
(``step_%010d/arrays.npz`` + ``manifest.json`` with a crc32 per leaf, leaf
names and order as ``jax.tree_util`` gives them), so a checkpoint written
by either package restores in the other.  A spec-built JAX ``Broker``
(freshness, a drift tracker, a live rebalance before the save) is saved
and restored into a port ``Broker``, and the other way round; the restored
broker must serve on request for request with the one that never
restarted.  Corruption (a flipped byte, a torn file), ``verify_step``,
``latest_verified_step``, the spec check and an allocation mismatch are
held to the reference's behaviour.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import serving as J  # noqa: E402
from repro.core import fast as jfast  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.loadgen.inject import corrupt_checkpoint  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro_torch import serving as T  # noqa: E402
from repro_torch.core import fast as tfast  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.freshness import FreshnessSpec as TFresh  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro.freshness import FreshnessSpec as JFresh  # noqa: E402

N_Q, V = 600, 2


def _backend(q):
    return np.tile(np.asarray(q, np.int64)[:, None], (1, V)).astype(np.int32)


def _stats(fast):
    rng = np.random.default_rng(0)
    keys = np.minimum(rng.zipf(1.2, size=6000) - 1, N_Q - 1).astype(np.int64)
    key_topic = rng.integers(-1, 4, size=N_Q)
    return fast.VecStats.from_log(fast.VecLog(keys=keys, n_train=4000, key_topic=key_topic))


def _broker(mod, n=256, **over):
    spec_mod, fast, fresh = (jspec, jfast, JFresh) if mod is J else (tspec, tfast, TFresh)
    serving = mod.ServingSpec(
        cache=spec_mod.CacheSpec.from_strategy("STDv_LRU", n, f_s=0.1, f_t=0.6),
        engine="device", ways=4, value_dim=V, microbatch=64,
        rebalance=mod.RebalanceSpec(every=1000, decay=0.9),
        bucket=mod.BucketSpec(mode="explicit", sizes=(64,)),
        freshness=fresh(ttl_s=4.0, stale_policy="miss"),
    )
    serving = dataclasses.replace(serving, **over)
    kw = {} if mod is J else dict(device="cpu")
    return mod.Broker.from_spec(serving, _stats(fast), [_backend], value_fn=_backend, **kw)


def _stream(seed, n):
    rng = np.random.default_rng(seed)
    return [np.minimum(rng.zipf(1.2, size=64) - 1, N_Q - 1) for _ in range(n)]


def _serve(b, batches, t0):
    out = []
    for i, q in enumerate(batches):
        b.advance_time(t0 + i)
        v, h = b.serve(q)
        assert np.array_equal(v, _backend(q))
        out.append(h)
    return out


def _words(b):
    b.flush()
    if isinstance(b.state["ks"], torch.Tensor):
        return T.state_to_numpy(b.state)
    return {k: np.asarray(v) for k, v in b.state.items()}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_restores_across_packages_and_serves_on(tmp_path, direction):
    src_mod, dst_mod = (J, T) if direction == "jax_to_port" else (T, J)
    src = _broker(src_mod)
    _serve(src, _stream(1, 10), 0.0)
    assert src.rebalance(force=True)  # the live allocation now differs from the spec's
    _serve(src, _stream(2, 4), 10.0)
    path = src.save(str(tmp_path), 3)
    assert os.path.basename(path) == "step_0000000003"
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert {"cache/ks", "stats/hits", "stats/topic_counts", "freshness/floors",
            "spec_json", "alloc_json"} <= set(manifest["keys"])
    assert manifest["dtypes"]["cache/ks"] == "uint32"
    dst = _broker(dst_mod)
    assert dst.cache.cfg.to_json() != src.cache.cfg.to_json()
    assert dst.restore(str(tmp_path)) == 3
    assert dst.cache.cfg.to_json() == src.cache.cfg.to_json()
    for k, v in _words(src).items():
        assert np.array_equal(v, _words(dst)[k]), k
    later = _stream(3, 8)
    assert all(np.array_equal(a, b) for a, b in
               zip(_serve(src, later, 14.0), _serve(dst, later, 14.0)))
    sj, sd = dataclasses.asdict(src.stats), dataclasses.asdict(dst.stats)
    assert all(np.array_equal(sj[k], sd[k]) for k in sj)
    for k, v in _words(src).items():
        assert np.array_equal(v, _words(dst)[k]), k
    src.close()
    dst.close()


def test_corruption_verification_and_mismatches(tmp_path):
    b = _broker(T)
    _serve(b, _stream(4, 6), 0.0)
    b.save(str(tmp_path), 1)
    _serve(b, _stream(5, 2), 6.0)
    b.save(str(tmp_path), 2)
    assert tck.all_steps(str(tmp_path)) == jck.all_steps(str(tmp_path)) == [1, 2]
    assert tck.verify_step(str(tmp_path), 2) and jck.verify_step(str(tmp_path), 2)
    corrupt_checkpoint(os.path.join(tmp_path, "step_0000000002"), mode="tamper", seed=0)
    assert not tck.verify_step(str(tmp_path), 2)
    assert tck.latest_verified_step(str(tmp_path)) == 1 == jck.latest_verified_step(str(tmp_path))
    fresh = _broker(T)
    before = _words(fresh)
    with pytest.raises(ValueError, match="checksum"):
        fresh.restore(str(tmp_path), step=2)
    assert all(np.array_equal(before[k], v) for k, v in _words(fresh).items())
    assert fresh.restore(str(tmp_path), step=tck.latest_verified_step(str(tmp_path))) == 1
    corrupt_checkpoint(os.path.join(tmp_path, "step_0000000001"), mode="truncate")
    assert tck.latest_verified_step(str(tmp_path)) is None
    # a checkpoint of another deployment fails informatively
    other = tmp_path / "other"
    _broker(T, n=512).save(str(other), 1)
    with pytest.raises(ValueError, match="different CacheSpec"):
        _broker(T).restore(str(other))
    no_spec = _broker(T, n=512)
    no_spec.spec = None
    no_spec.save(str(other), 2)
    target = _broker(T)
    target.spec = None
    with pytest.raises(ValueError, match="incompatible"):
        target.restore(str(other), step=2)
    with pytest.raises(FileNotFoundError):
        target.restore(str(tmp_path / "empty"))


def test_checkpoint_library_reads_across_packages(tmp_path):
    tree = {"b": {"y": np.arange(6, dtype=np.int32).reshape(2, 3), "x": np.float64(2.5)},
            "a": np.zeros(4, np.uint32), "c": [np.ones(2), (np.int64(7), None)]}
    tck.save(str(tmp_path / "t"), 5, tree, keep=2)
    jck.save(str(tmp_path / "j"), 5, tree, keep=2)
    mt = tck.read_manifest(str(tmp_path / "t"), 5)
    mj = jck.read_manifest(str(tmp_path / "j"), 5)
    assert mt == mj
    got_j, _ = jck.restore(str(tmp_path / "t"), tree)
    got_t, step = tck.restore(str(tmp_path / "j"), tree)
    assert step == 5 and got_t["c"][1][1] is None and isinstance(got_t["c"][1], tuple)
    for k, leaf in tck._flatten_with_paths(tree):
        assert np.array_equal(dict(tck._flatten_with_paths(got_t))[k], leaf)
        assert np.array_equal(dict(jck._flatten_with_paths(got_j))[k], leaf)
    assert np.array_equal(tck.load_leaf(str(tmp_path / "j"), 5, "b/y"), tree["b"]["y"])
    assert tck.load_leaf(str(tmp_path / "j"), 5, "missing") is None
    # a tensor leaf is saved in its own dtype; keep bounds the ring
    for s in range(3):
        tck.save(str(tmp_path / "t"), 6 + s, {"w": torch.arange(3, dtype=torch.int32)}, keep=2)
    assert tck.all_steps(str(tmp_path / "t")) == [7, 8]
    assert tck.latest_step(str(tmp_path / "t")) == 8
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.restore(str(tmp_path / "t"), {"w": np.zeros(4, np.int32)})
    with pytest.raises(KeyError):
        tck.restore(str(tmp_path / "t"), {"v": np.zeros(3, np.int32)})
