"""The port's ``build_step`` on a mesh against the reference's.

The 20 cells of ``tests/test_steps_smoke.py`` (each arch's first and last
shape, smoke configs) run through the port's ``build_step(arch, shape,
mesh, smoke=True).jitted()`` on a one-rank gloo mesh and through the
reference's ``build_step(..., make_smoke_mesh(), smoke=True).jitted()``,
with the same parameters (the reference's init, carried across by each
family's ``params_from_numpy``), optimizer state and seeded inputs.  Every
output leaf is held to the reference's.

Tolerances.  Every smoke config computes in f32 (none has a bf16 output):
rtol 1e-4, atol 1e-5, the differences of XLA's and torch's f32 dots and
transcendentals on the CPU (one ulp each) through a step.  A train step
holds the loss and every updated parameter and moment.

Also: ``input_specs`` against the reference's ``ShapeDtypeStruct``s (paths,
shapes, dtypes) for all 40 cells at full size (meta tensors, so nothing is
allocated), and ``all_cells`` in order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_smoke_mesh as jmesh  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.common import tensor_from_numpy, tree_leaves  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
DTYPES = {np.dtype("float32"): torch.float32, np.dtype("int32"): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}

CELLS = []
for _arch in jreg.ARCHS.values():
    CELLS.append((_arch.name, _arch.shapes[0].name))
    CELLS.append((_arch.name, _arch.shapes[-1].name))


@pytest.fixture(scope="module")
def mesh():
    """A gloo world of one and its (1, 1) mesh, torn down after the module
    (other test files in this worker expect no process group)."""
    m = make_smoke_mesh(device="cpu")
    yield m
    ttf.set_moe_mesh(None)
    torch.distributed.destroy_process_group()


def _concretize(spec, rng):
    """The reference test's inputs: ids in [0, 8), f32 normals, zeros."""
    def make(s):
        if s.dtype == jnp.int32 and len(s.shape) >= 1:
            return rng.integers(0, 8, size=s.shape).astype(np.int32)
        if s.dtype == jnp.float32:
            return rng.normal(size=s.shape).astype(np.float32)
        return np.zeros(s.shape, s.dtype)

    return jax.tree.map(make, spec)


def _params(arch):
    key = jax.random.PRNGKey(0)
    if arch.family == "lm":
        jp = jtf.init_params(key, arch.smoke_config)
        return jp, ttf.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    if arch.family == "gnn":
        jp = jgnn.init_params(key, arch.smoke_config)
        return jp, tgnn.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jp = jsteps._RECSYS_INIT[arch.name](key, arch.smoke_config)
    return jp, trec.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return tensor_from_numpy(tree, "cpu")


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _leaves_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _run(arch_name, shape_name, mesh):
    jarch, tarch = jreg.ARCHS[arch_name], treg.ARCHS[arch_name]
    jshape, tshape = jarch.shape(shape_name), tarch.shape(shape_name)
    rng = np.random.default_rng(0)
    jbundle = jsteps.build_step(jarch, jshape, jmesh(), smoke=True)
    tbundle = tsteps.build_step(tarch, tshape, mesh, smoke=True)
    jp, tp = _params(jarch)
    jin, tin = [jp], [tp]
    if jshape.kind == "train":
        big = jarch.family == "lm" and (jarch.config.moe is not None
                                        or jarch.config.param_count() > 2e10)
        jo = joptim.init_adafactor_state(jp) if big else joptim.init_opt_state(jp)
        jin.append(jo)
        tin.append(toptim.opt_state_from_numpy(jax.tree.map(np.asarray, jo), device="cpu"))
        rest = jbundle.inputs[2:]
    else:
        rest = jbundle.inputs[1:]
    for spec in rest:
        arr = _concretize(spec, rng)
        jin.append(jax.tree.map(jnp.asarray, arr))
        tin.append(_torch_tree(arr))
    with jmesh():
        want = jbundle.jitted()(*jin)
    got = tbundle.jitted()(*tin)
    return jshape.kind, want, got


@pytest.mark.parametrize("arch_name,shape_name", CELLS)
def test_smoke_cell_on_a_mesh_equals_the_reference(arch_name, shape_name, mesh):
    kind, want, got = _run(arch_name, shape_name, mesh)
    if kind == "train":
        jparams, jopt, jout = want
        tparams, topt, tout = got
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), **TOL)
        pairs = list(zip(_leaves_np(jparams), tree_leaves(tparams)))
        pairs += list(zip(_leaves_np(jopt), tree_leaves(topt)))
    else:
        pairs = list(zip(_leaves_np(want), tree_leaves(got)))
    assert pairs
    for w, g in pairs:
        g = _full(g).detach().float().numpy()
        assert g.shape == w.shape
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL)


def _paths_shapes_dtypes(tree, torch_side):
    if torch_side:
        leaves = tree_leaves(tree)
        return [(tuple(t.shape), t.dtype, t.device.type) for t in leaves]
    return [(tuple(s.shape), DTYPES[np.dtype(s.dtype)], "meta") for s in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch_name", sorted(jreg.ARCHS))
def test_input_specs_equal_the_references_at_full_size(arch_name, mesh):
    """Every cell's abstract inputs (params, optimizer state, batch, cache),
    leaf for leaf in the reference's order: shapes, dtypes, on meta."""
    jarch, tarch = jreg.ARCHS[arch_name], treg.ARCHS[arch_name]
    for shape in jarch.shapes:
        want = jsteps.input_specs(jarch, shape, jmesh())
        got = tsteps.input_specs(tarch, tarch.shape(shape.name), mesh)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert _paths_shapes_dtypes(g, True) == _paths_shapes_dtypes(w, False), shape.name
            assert [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(w)[0]]


def test_all_cells_in_the_references_order():
    want = [(a.name, s.name) for a, s in jreg.all_cells()]
    got = [(a.name, s.name) for a, s in treg.all_cells()]
    assert got == want and len(got) == 40
