"""The port's mesh paths over several ranks on the CPU, against the
reference's on as many devices.

The port runs in a world of 4 gloo processes (spawned, rendezvoused through
a ``FileStore`` under ``tmp_path``, torn down after); the reference in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
which writes its parameters, inputs and outputs to an ``.npz``.  Each world
and each subprocess is given 60 s.

* the shard-local MoE (llama4-scout's smoke config, ``capacity`` and
  ``ragged``) on a 2x2 ("data", "model") mesh with ``fsdp=("data",)`` and
  ``tp="model"``: ``forward``'s logits and aux against the reference's
  ``forward`` on its 2x2 mesh at batch 4, and ``_moe_ffn`` at a decode
  batch of 1 token (padded to the 2 shards); ``loss_fn``'s gradients
  against the reference's ``jax.grad`` on that mesh, and (ragged, no aux)
  against one rank's;
* the sequence-parallel residual (``act_seq_axis="model"``): ``forward``
  bit-equal to the same mesh without it, and ``loss_fn``'s gradients with
  remat equal;
* ``forward_dist`` over 4 node shards of a (pod, data) mesh, on edges
  partitioned by destination: against the reference's ``forward_dist``, and
  against ``forward``, with its gradients;
* every rank's block of a tuple-axis placement (``layers/moe/wi`` over
  ("pod", "data") and "model", a KV cache's S over three axes) against the
  reference ``NamedSharding``'s ``devices_indices_map`` at the same mesh
  position;
* one smoke train step of gemma-2b (AdamW, global clip) and of two-tower
  (its tables row-sharded over "model", in-batch softmax over the gathered
  items) on the 2x2 mesh against the same step on one rank.

Tolerances: f32 throughout; values rtol 1e-5, atol 1e-6 (an ulp of XLA's
and torch's dots and exps, and the ranks' sums in another order), a
forward's logits rtol 1e-5, atol 2e-5 (``tests/test_torch_moe.py``'s); the
capacity MoE's routing and drops are exact.  Gradients rtol 1e-4, atol
1e-6 times the leaf's largest entry (the top-1 router's 5e-5; without the
aux its gradient is 0, a rounding on both sides); a train step's
parameters rtol 1e-4, atol 1e-5 (a first AdamW step moves an entry by
the sign of its gradient, which an ulp can flip where it is ~0), its
moments as gradients.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 60
VAL = dict(rtol=1e-5, atol=1e-6)
#: a forward's logits, as tests/test_torch_moe.py holds them
LOGIT = dict(rtol=1e-5, atol=2e-5)
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6
#: a first AdamW step moves each entry by about lr * warmup = 3e-6, its sign
#: that of the gradient: an entry whose gradient is a rounding from 0 can
#: flip (tests/test_torch_moe.py's PARAM_ATOL)
STEP = dict(rtol=1e-4, atol=1e-5)
#: top-1's renormalised weight is p / p = 1: the router's gradient through
#: it is a cancellation (tests/test_torch_moe.py's ROUTER_TOP1_ATOL_REL)
ROUTER_ATOL_REL = 5e-5
SEQ = 16
GRAPH = (32, 120)  # nodes (divisible by 4 shards), edges

REFERENCE = r'''
import os, sys, json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import registry as reg
from repro.launch.mesh import make_smoke_mesh
from repro.launch.shardings import LM_RULES, spec_for_path, kv_cache_spec
from repro.models import gnn, transformer as tf
import dataclasses as dc

out_path, seq = sys.argv[1], int(sys.argv[2])
out = {}
def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = np.asarray(leaf)

rng = np.random.default_rng(0)
mesh = make_smoke_mesh((2, 2), ("data", "model"))
tf.set_moe_mesh(mesh)
base = reg.get_arch("llama4-scout-17b-a16e").smoke_config
params = tf.init_params(jax.random.PRNGKey(0), base)
put("params/", params)
tokens = rng.integers(0, base.vocab_size, (4, seq)).astype(np.int32)
x1 = rng.normal(size=(1, base.d_model)).astype(np.float32)
out["tokens"], out["x1"] = tokens, x1
for impl in ("capacity", "ragged"):
    cfg = dc.replace(base, moe=dc.replace(base.moe, impl=impl), moe_batch_axes=("data",),
                     moe_tp_axis="model", moe_fsdp_axes=("data",))
    with mesh:
        logits, aux = jax.jit(lambda p, t: tf.forward(p, t, cfg))(params, jnp.asarray(tokens))
        layer0 = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
        y1, aux1 = jax.jit(lambda m, x: tf._moe_ffn(m, x, cfg))(layer0, jnp.asarray(x1))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: tf.loss_fn(p, {"tokens": jnp.asarray(tokens)}, cfg)))(params)
    out[f"{impl}/logits"], out[f"{impl}/aux"] = np.asarray(logits), np.asarray(aux)
    out[f"{impl}/y1"], out[f"{impl}/aux1"] = np.asarray(y1), np.asarray(aux1)
    out[f"{impl}/loss"] = np.asarray(loss)
    put(f"{impl}/grads/", grads)

blocks = {}
for shape3 in ((2, 2, 1), (2, 1, 2), (1, 2, 2)):
    m = make_smoke_mesh(shape3, ("pod", "data", "model"))
    for name, shape, spec in (
        ("wi", (2, 16, 4, 2, 8), spec_for_path("layers/moe/wi", (2, 16, 4, 2, 8), LM_RULES, m)),
        ("kv", (2, 1, 32, 2, 4), kv_cache_spec(m, 1, 32, 2)),
    ):
        idx = NamedSharding(m, spec).devices_indices_map(shape)
        for pos in np.ndindex(*m.devices.shape):
            sl = idx[m.devices[pos]]
            blocks["x".join(map(str, shape3)) + f"/{name}/" + ",".join(map(str, pos))] = [
                [s.start or 0, s.stop if s.stop is not None else n] for s, n in zip(sl, shape)]
        blocks["x".join(map(str, shape3)) + f"/{name}/spec"] = [
            list(a) if isinstance(a, tuple) else a for a in spec]
out["blocks"] = np.array(json.dumps(blocks))
np.savez(out_path, **out)
'''

GNN_REFERENCE = r'''
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from repro.configs import registry as reg
from repro.launch.mesh import make_smoke_mesh
from repro.models import gnn

out_path, n_nodes, n_edges = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
out = {}
rng = np.random.default_rng(1)
gmesh = make_smoke_mesh((2, 2), ("pod", "data"))
gcfg = reg.get_arch("pna").smoke_config
gp = jax.tree.map(lambda a: np.asarray(a, np.float64), gnn.init_params(jax.random.PRNGKey(1), gcfg))
for path, leaf in jax.tree_util.tree_flatten_with_path(gp)[0]:
    out["gparams/" + "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = leaf
g = gnn.make_random_graph(n_nodes, n_edges, gcfg.d_in, gcfg.n_classes, seed=5)
ei = gnn.partition_edges_by_dst(g["edge_index"], n_nodes, 4).astype(np.int32)
x = g["x"].astype(np.float64)
r = rng.normal(size=(n_nodes, gcfg.n_classes))
out["gx"], out["gei"], out["gr"] = x, ei, r
with gmesh:
    f = lambda p: gnn.forward_dist(p, jnp.asarray(x), jnp.asarray(ei), gcfg, gmesh, ("pod", "data"))
    out["dist"] = np.asarray(jax.jit(f)(gp))
    dgrads = jax.jit(jax.grad(lambda p: (f(p) * r).sum()))(gp)
for path, leaf in jax.tree_util.tree_flatten_with_path(dgrads)[0]:
    out["dgrads/" + "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = np.asarray(leaf)
np.savez(out_path, **out)
'''


def _tree(flat, prefix):
    """The nested dict (lists where keys are indices) under ``prefix``."""
    root = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(t):
        if isinstance(t, dict):
            if t and all(k.isdigit() for k in t):
                return [fix(t[k]) for k in sorted(t, key=int)]
            return {k: fix(v) for k, v in t.items()}
        return t

    return fix(root)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's run: the LM parts in f32, the GNN's in float64 (on a
    power-law graph a hub's f32 std is a rounding, as in
    tests/test_torch_gnn.py), the two subprocesses side by side.  (JAX is
    asked for here, not at the module's top: the port's spawned ranks
    import this module and need none of it.)"""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    runs = [subprocess.Popen([sys.executable, "-c", code, str(d / name), *args], cwd=ROOT,
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for code, name, args in ((REFERENCE, "lm.npz", (str(SEQ),)),
                                     (GNN_REFERENCE, "gnn.npz", tuple(map(str, GRAPH))))]
    out = {}
    for run, name in zip(runs, ("lm.npz", "gnn.npz")):
        _, err = run.communicate(timeout=TIMEOUT)
        assert run.returncode == 0, err[-4000:]
        with np.load(d / name) as f:
            out.update({k: f[k] for k in f.files})
    return out


# ---------------------------------------------------------------------------
# the port's world of 4
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    from repro_torch.models.common import tree_map_with_path

    out = {}
    tree_map_with_path(lambda p, t: out.__setitem__(prefix + p, t), tree)
    return out


def _np(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().cpu().numpy()


def _world(rank, world, store_path, ref_path, out_dir):
    import dataclasses as dc

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.shardings import (LM_RULES, NamedSharding, batch_spec,
                                              kv_cache_spec, param_shardings, spec_for_path)
    from repro_torch.models import gnn, transformer as tf
    from repro_torch.models.common import tree_leaves

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    res = {}
    with np.load(ref_path) as f:
        ref = {k: f[k] for k in f.files}
    mesh = make_smoke_mesh((2, 2), ("data", "model"), device="cpu")
    tf.set_moe_mesh(mesh)

    def placed(tree, family="lm"):
        return S.place_tree(tree, param_shardings(tree, mesh, family))

    # -- the shard-local MoE -------------------------------------------------
    base = get_arch("llama4-scout-17b-a16e").smoke_config
    jparams = _tree(ref, "params/")
    tokens = torch.from_numpy(ref["tokens"])
    tok_dt = S.place(tokens, NamedSharding(mesh, batch_spec(mesh, 4, 2)))
    for impl in ("capacity", "ragged"):
        cfg = dc.replace(base, moe=dc.replace(base.moe, impl=impl), moe_batch_axes=("data",),
                         moe_tp_axis="model", moe_fsdp_axes=("data",))
        params = tf.params_from_numpy(jparams, device="cpu")
        p_dt = placed(params.tree())
        with torch.no_grad():
            logits, aux = tf.forward(p_dt, tok_dt, cfg)
            layer0 = {k: v[0] for k, v in p_dt["layers"]["moe"].items()}
            y1, aux1 = tf._moe_ffn(layer0, torch.from_numpy(ref["x1"]), cfg)
        res[f"{impl}/logits"], res[f"{impl}/aux"] = _np(logits), _np(aux)
        res[f"{impl}/y1"], res[f"{impl}/aux1"] = _np(y1), _np(aux1)
        loss, grads = S.value_and_grad(tf.loss_fn)(p_dt, {"tokens": tok_dt}, cfg)
        res[f"{impl}/loss"] = _np(loss)
        res.update({f"{impl}/grads/{k}": _np(v) for k, v in _flat(grads).items()})
    # ragged without the aux: the mesh's gradients against one rank's
    cfg = dc.replace(base, moe=dc.replace(base.moe, impl="ragged", router_aux_weight=0.0),
                     moe_batch_axes=("data",), moe_tp_axis="model", moe_fsdp_axes=("data",))
    one = dc.replace(cfg, moe_batch_axes=None, moe_tp_axis=None, moe_fsdp_axes=())
    _, g_mesh = S.value_and_grad(tf.loss_fn)(
        placed(tf.params_from_numpy(jparams, device="cpu").tree()), {"tokens": tok_dt}, cfg)
    res.update({f"noaux/mesh/{k}": _np(v) for k, v in _flat(g_mesh).items()})

    # -- the sequence-parallel residual ---------------------------------------
    gemma = get_arch("gemma-2b")
    gcfg = dc.replace(gemma.smoke_config, remat=True, moe_batch_axes=("data",))
    gp = tf.init_params(torch.Generator().manual_seed(3), gcfg)
    gtok = torch.randint(0, gcfg.vocab_size, (4, SEQ), generator=torch.Generator().manual_seed(4))
    gtok_dt = S.place(gtok, NamedSharding(mesh, batch_spec(mesh, 4, 2)))
    for name, c in (("plain", gcfg), ("seq", dc.replace(gcfg, act_seq_axis="model"))):
        with torch.no_grad():
            res[f"sp/{name}/logits"] = _np(tf.forward(placed(gp.tree()), gtok_dt, c)[0])
        loss, grads = S.value_and_grad(tf.loss_fn)(placed(gp.tree()), {"tokens": gtok_dt}, c)
        res[f"sp/{name}/loss"] = _np(loss)
        res.update({f"sp/{name}/grads/{k}": _np(v) for k, v in _flat(grads).items()})

    # -- train steps on the mesh (one rank's after the collectives, below) ----
    def train_case(arch_name, shape_name, seed):
        arch = get_arch(arch_name)
        gen = torch.Generator().manual_seed(seed)
        if arch.family == "lm":
            p0 = tf.init_params(gen, arch.smoke_config).tree()
            batch = {"tokens": torch.randint(0, 8, (4, 64), generator=gen, dtype=torch.int32)}
        else:
            p0 = S.RECSYS_INIT[arch.name](gen, arch.smoke_config)
            batch = S.recsys_train_fns(arch, arch.smoke_config)[1](64, gen)
        return arch, arch.shape(shape_name), p0, batch

    def train_step(arch, shape, m, p0, batch):
        bundle = S.build_step(arch, shape, m, smoke=True)
        p = S.tree_map(lambda t: t.clone(), p0)
        return bundle.jitted()(p, S.optim.init_opt_state(p), dict(batch))

    cases = (("gemma-2b", "train_4k", 5), ("two-tower-retrieval", "train_batch", 6))
    for arch_name, shape_name, seed in cases:
        arch, shape, p0, batch = train_case(arch_name, shape_name, seed)
        params, opt, out = train_step(arch, shape, mesh, p0, batch)
        res[f"step/{arch_name}/loss/mesh"] = _np(out["loss"])
        for kind, leaves in (("p", tree_leaves(params)), ("o", tree_leaves(opt))):
            for i, t in enumerate(leaves):
                res[f"step/{arch_name}/{kind}{i}/mesh"] = _np(t)
        if arch.family == "recsys":
            res[f"step/{arch_name}/table_placements"] = np.array(
                str(params["user_table"].placements))

    # -- forward_dist over 4 node shards --------------------------------------
    dmesh = make_smoke_mesh((2, 2), ("pod", "data"), device="cpu")
    pcfg = dc.replace(get_arch("pna").smoke_config, dtype=torch.float64)
    gpar = gnn.params_from_numpy(_tree(ref, "gparams/"), device="cpu")  # float64
    rep = S.place_tree(gpar, S.tree_map(lambda t: NamedSharding(dmesh, ()), gpar))
    x = torch.from_numpy(ref["gx"])
    ei = torch.from_numpy(ref["gei"])
    r = torch.from_numpy(ref["gr"])
    x_dt = S.place(x, NamedSharding(dmesh, (("pod", "data"), None)))
    ei_dt = S.place(ei, NamedSharding(dmesh, (None, ("pod", "data"))))
    loss, dgrads = S.value_and_grad(lambda p: (gnn.forward_dist(
        p, x_dt, ei_dt, pcfg, dmesh, ("pod", "data")).full_tensor() * r).sum())(rep)
    with torch.no_grad():
        res["dist/out"] = _np(gnn.forward_dist(rep, x_dt, ei_dt, pcfg, dmesh, ("pod", "data")))
    res.update({f"dist/grads/{k}": _np(v) for k, v in _flat(dgrads).items()})

    # -- tuple-axis placements -----------------------------------------------
    for shape3 in ((2, 2, 1), (2, 1, 2), (1, 2, 2)):
        m = make_smoke_mesh(shape3, ("pod", "data", "model"), device="cpu")
        key = "x".join(map(str, shape3))
        pos = ",".join(str(int(c)) for c in m.get_coordinate())
        for name, shape, spec in (
            ("wi", (2, 16, 4, 2, 8), spec_for_path("layers/moe/wi", (2, 16, 4, 2, 8), LM_RULES, m)),
            ("kv", (2, 1, 32, 2, 4), kv_cache_spec(m, 1, 32, 2)),
        ):
            whole = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
            res[f"blocks/{key}/{name}/{pos}"] = _np(S.place(whole, NamedSharding(m, spec)).to_local())
            res[f"blocks/{key}/{name}/spec"] = np.array(json.dumps(
                [list(a) if isinstance(a, tuple) else a for a in spec]))
    # -- one rank's runs, which rank 0 holds the mesh's to ---------------------
    dist.barrier()
    if rank == 0:
        _, g_one = S.value_and_grad(tf.loss_fn)(tf.params_from_numpy(jparams, device="cpu"),
                                                {"tokens": tokens}, one)
        res.update({f"noaux/one/{k}": _np(v) for k, v in _flat(g_one).items()})
        for arch_name, shape_name, seed in cases:
            arch, shape, p0, batch = train_case(arch_name, shape_name, seed)
            params, opt, out = train_step(arch, shape, None, p0, batch)
            res[f"step/{arch_name}/loss/one"] = _np(out["loss"])
            for kind, leaves in (("p", tree_leaves(params)), ("o", tree_leaves(opt))):
                for i, t in enumerate(leaves):
                    res[f"step/{arch_name}/{kind}{i}/one"] = _np(t)
        with torch.no_grad():
            res["dist/forward"] = _np(gnn.forward(gpar, x, ei, pcfg))
        _, fgrads = S.value_and_grad(lambda p: (gnn.forward(p, x, ei, pcfg) * r).sum())(
            gnn.params_from_numpy(_tree(ref, "gparams/"), device="cpu"))
        res.update({f"dist/fgrads/{k}": _np(v) for k, v in _flat(fgrads).items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("port")
    ref_path = d / "ref.npz"
    np.savez(ref_path, **reference)
    ctx = mp.start_processes(_world, args=(4, str(d / "store"), str(ref_path), str(d)),
                             nprocs=4, join=False, start_method="spawn")
    import time

    deadline = time.monotonic() + TIMEOUT
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the 4-rank world did not finish in {TIMEOUT} s")
    out = []
    for r in range(4):
        with np.load(d / f"rank{r}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


def _close_grads(got, want, rtol=GRAD_RTOL, atol_rel=GRAD_ATOL_REL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_shard_local_moe_forward_equals_the_references_2x2(impl, reference, port):
    for rank in port:
        np.testing.assert_allclose(rank[f"{impl}/logits"], reference[f"{impl}/logits"], **LOGIT)
        np.testing.assert_allclose(rank[f"{impl}/aux"], reference[f"{impl}/aux"], **VAL)
        # a decode batch of one token: padded to the 2 batch shards
        np.testing.assert_allclose(rank[f"{impl}/y1"], reference[f"{impl}/y1"], **VAL)
        np.testing.assert_allclose(rank[f"{impl}/aux1"], reference[f"{impl}/aux1"], **VAL)


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_shard_local_moe_gradients_equal_the_references_2x2(impl, reference, port):
    want = {k[len(f"{impl}/grads/"):]: v for k, v in reference.items()
            if k.startswith(f"{impl}/grads/")}
    got = {k[len(f"{impl}/grads/"):]: v for k, v in port[0].items()
           if k.startswith(f"{impl}/grads/")}
    assert got.keys() == want.keys() and len(got) > 5
    np.testing.assert_allclose(port[0][f"{impl}/loss"], reference[f"{impl}/loss"], **VAL)
    for k in want:
        _close_grads(got[k], want[k],
                     atol_rel=ROUTER_ATOL_REL if k.endswith("moe/router") else GRAD_ATOL_REL)


def test_moe_gradients_on_the_mesh_equal_one_ranks(port):
    """Ragged (dropless) and without the aux, the MoE on the mesh is the
    one-device function: the gradients match."""
    mesh = {k[len("noaux/mesh/"):]: v for k, v in port[0].items() if k.startswith("noaux/mesh/")}
    one = {k[len("noaux/one/"):]: v for k, v in port[0].items() if k.startswith("noaux/one/")}
    assert mesh.keys() == one.keys() and mesh
    scale = max(float(np.abs(v).max()) for v in one.values())
    for k in mesh:
        if k.endswith("moe/router"):  # 0 but for roundings, on both
            assert np.abs(mesh[k]).max() <= 1e-6 * scale and np.abs(one[k]).max() <= 1e-6 * scale
        else:
            _close_grads(mesh[k], one[k])


def test_sequence_parallel_residual_changes_no_value(port):
    for rank in port:
        np.testing.assert_array_equal(rank["sp/seq/logits"], rank["sp/plain/logits"])
        np.testing.assert_array_equal(rank["sp/seq/loss"], rank["sp/plain/loss"])
        keys = [k for k in rank if k.startswith("sp/plain/grads/")]
        assert keys
        for k in keys:
            _close_grads(rank[k.replace("/plain/", "/seq/")], rank[k], rtol=1e-6, atol_rel=1e-7)


def test_forward_dist_over_four_shards(reference, port):
    want = {k[len("dgrads/"):]: v for k, v in reference.items() if k.startswith("dgrads/")}
    assert want
    for rank in port:
        np.testing.assert_allclose(rank["dist/out"], reference["dist"], **VAL)
        np.testing.assert_allclose(rank["dist/out"], port[0]["dist/forward"], **VAL)
        for k, w in want.items():
            _close_grads(rank[f"dist/grads/{k}"], w)
            _close_grads(rank[f"dist/grads/{k}"], port[0][f"dist/fgrads/{k}"])


def test_tuple_axis_blocks_equal_the_references_devices_indices_map(reference, port):
    blocks = json.loads(str(reference["blocks"]))
    n = 0
    for rank in port:
        for key, block in rank.items():
            if not key.startswith("blocks/") or key.endswith("/spec"):
                continue
            mesh_key, name, pos = key.split("/")[1:]
            assert json.loads(str(rank[f"blocks/{mesh_key}/{name}/spec"])) == \
                blocks[f"{mesh_key}/{name}/spec"]
            shape = (2, 16, 4, 2, 8) if name == "wi" else (2, 1, 32, 2, 4)
            whole = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
            want = whole[tuple(slice(a, b) for a, b in blocks[f"{mesh_key}/{name}/{pos}"])]
            np.testing.assert_array_equal(block, want)
            n += 1
    assert n == 4 * 3 * 2


@pytest.mark.parametrize("arch_name", ["gemma-2b", "two-tower-retrieval"])
def test_train_step_on_the_mesh_equals_one_rank(arch_name, port):
    rank = port[0]
    np.testing.assert_allclose(rank[f"step/{arch_name}/loss/mesh"],
                               rank[f"step/{arch_name}/loss/one"], **VAL)
    n = {"p": 0, "o": 0}
    for kind in n:
        while f"step/{arch_name}/{kind}{n[kind]}/mesh" in rank:
            got = rank[f"step/{arch_name}/{kind}{n[kind]}/mesh"]
            want = rank[f"step/{arch_name}/{kind}{n[kind]}/one"]
            if kind == "p":
                np.testing.assert_allclose(got, want, **STEP)
            else:
                _close_grads(got, want)
            n[kind] += 1
    assert n["p"] > 4 and n["o"] > 4
    if arch_name == "two-tower-retrieval":
        assert "Shard(dim=0)" in str(rank[f"step/{arch_name}/table_placements"])
