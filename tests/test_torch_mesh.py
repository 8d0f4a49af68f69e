"""The port's multi-device layer: the mesh factories (``launch/mesh.py``),
the sharding rules and spec trees (``launch/sharding.py``) against the JAX
package's, and the SPMD gathers the sweeps use (``gather_leading``,
``fl/fused_round._gather_rows``) on a gloo group.

Ranks are subprocesses (``tests/_torch_ranks.py``): one launch of 2 ranks
(the world-2 meshes and the gathers, held bit for bit against a plain
``index_select``) and one of 4 (the world-4 meshes).  The spec trees of
every config of the registry are built from the full configs' shapes —
meta tensors on the port's side, ``jax.eval_shape`` on the JAX package's —
and must be equal spec for spec, with and without the 16×16 mesh's
sanitizing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_ranks import Ranks
from repro.configs import ARCHS as J_ARCHS
from repro.launch import sharding as jsh
from repro.launch import steps as JS
from repro_torch.configs import ARCHS
from repro_torch.core.trees import tree_leaves
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as S
from repro_torch.launch.sharding import P


class _FakeMesh:
    shape = {"data": 16, "model": 16}


def _t(spec):
    """A JAX ``PartitionSpec`` as the tuple the port's ``P`` is."""
    return tuple(spec)


# ---------------------------------------------------------------------------
# factories without a process group
# ---------------------------------------------------------------------------
def test_sweep_meshes_are_none_without_a_group():
    assert M.world_size() == 1
    assert M.make_sweep_mesh() is None
    assert M.make_sweep_mesh(1) is None
    assert M.make_population_mesh() is None
    assert M.make_population_mesh(n_scenario=1, n_clients=1) is None


def test_exact_meshes_need_their_world():
    with pytest.raises(ValueError, match="needs an initialized process "
                                         "group of 256 ranks, have 1"):
        M.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="of 512 ranks"):
        M.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="of 1 ranks, have 1 \\(no process"):
        M.make_debug_mesh(device="cpu")


def test_axis_helpers_on_a_stand_in():
    m = _FakeMesh()
    m.axis_names = ("data", "model")
    assert M.data_axes(m) == ("data",) == M.fsdp_axes(m)
    assert M.n_data_shards(m) == 16
    pod = type("Pod", (), {"axis_names": ("pod", "data", "model"),
                           "shape": {"pod": 2, "data": 16, "model": 16}})()
    assert M.data_axes(pod) == ("pod", "data")
    assert M.n_data_shards(pod) == 32


# ---------------------------------------------------------------------------
# rules and specs against the JAX package
# ---------------------------------------------------------------------------
RULE_CASES = [
    ("blocks/l0/mixer/wq/w", 3, P(None, "data", "model")),
    ("blocks/l0/mixer/wo/w", 3, P(None, "model", "data")),
    ("blocks/l0/ffn/wg", 4, P(None, "model", "data", None)),
    ("blocks/l0/ffn/wg/w", 3, P(None, "data", "model")),
    ("embed", 2, P("model", "data")),
    ("lm_head", 2, P("data", "model")),
    ("blocks/l0/norm1", 2, P(None, None)),
    ("blocks/l3/mixer/wx", 3, P(None, "data", "model")),
]


@pytest.mark.parametrize("fsdp", [("data",), ("pod", "data"), None])
@pytest.mark.parametrize("path,ndim,want", RULE_CASES,
                         ids=[c[0] + f"-{c[1]}" for c in RULE_CASES])
def test_param_rules(path, ndim, want, fsdp):
    got = sh.param_pspec(path, ndim, fsdp)
    assert got == _t(jsh.param_pspec(path, ndim, fsdp))
    if fsdp == ("data",):
        assert got == want


SANITIZE_CASES = [
    (P("model", "data"), (50280, 1024), P(None, "data")),
    (P(None, "model"), (512, 51865), P(None, None)),
    (P("model", None), (256, 7), P("model", None)),
    (P(("data", "model"), None), (512, 3), P(("data", "model"), None)),
    (P(("data", "model"), None), (128, 3), P(None, None)),
]


@pytest.mark.parametrize("spec,shape,want", SANITIZE_CASES)
def test_sanitize_drops_nondivisible(spec, shape, want):
    got = sh.sanitize_pspec(spec, shape, _FakeMesh())
    assert got == want
    assert got == _t(jsh.sanitize_pspec(JP(*spec), shape, _FakeMesh()))


def test_logical_pspec():
    class Mesh1D:
        axis_names = ("scenario",)

    class Mesh2D:
        axis_names = ("scenario", "clients")
    for axes in [("rounds", "clients"), ("scenario",), ("clients",),
                 ("rounds",), (None, "batch"), ("unknown", "clients")]:
        for mesh in (None, Mesh1D(), Mesh2D()):
            assert sh.logical_pspec(axes, mesh) == \
                _t(jsh.logical_pspec(axes, mesh)), (axes, mesh)
    assert sh.logical_pspec(("rounds", "clients"), Mesh2D()) == \
        P(None, "clients")
    assert sh.logical_pspec(("rounds", "clients"), Mesh1D()) == P(None, None)


def _tuples(tree):
    return jax.tree.map(_t, tree, is_leaf=lambda x: isinstance(x, JP))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_tree_and_opt_state_pspecs_equal_jax(name):
    """Every config of the registry at full size, FSDP over ``data``, on
    the 16×16 mesh: the parameter specs (raw and sanitized) and the
    optimizer state's specs equal the JAX package's, spec for spec and
    path for path."""
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    pshape = S.params_shape(cfg)
    jshape = JS.params_shape(jcfg)
    fsdp = ("data",)
    for mesh in (None, _FakeMesh()):
        got = sh.tree_pspecs(pshape, fsdp, mesh=mesh)
        want = _tuples(jsh.tree_pspecs(jshape, fsdp, mesh=mesh))
        assert tree_leaves(got) == jax.tree.leaves(
            want, is_leaf=lambda x: isinstance(x, tuple))
        assert any(a is not None for s in tree_leaves(got) for a in s)
    opt, opt_name = S.make_optimizer(cfg)
    jopt, jopt_name = JS.make_optimizer(jcfg)
    assert opt_name == jopt_name
    with torch.device("meta"):
        oshape = opt.init(pshape)
    joshape = jax.eval_shape(jopt.init, jshape)
    got = sh.sanitize_tree(sh.opt_state_pspecs(oshape, pshape, fsdp), oshape,
                           _FakeMesh())
    want = jsh.sanitize_tree(jsh.opt_state_pspecs(joshape, jshape, fsdp),
                             joshape, _FakeMesh())
    assert sorted(got) == sorted(want)
    assert tree_leaves(got) == [_t(s) for s in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, JP))]


def test_pad_and_slice_leading_axis_equal_jax():
    rng = np.random.default_rng(0)
    tree = {"V": rng.standard_normal(5).astype(np.float32),
            "has": rng.random((5, 2, 3)) < 0.5,
            "D": rng.integers(0, 9, (5, 3)).astype(np.int32)}
    for multiple in (1, 2, 4, 5):
        got = sh.pad_leading_axis({k: torch.as_tensor(v)
                                   for k, v in tree.items()}, multiple)
        want = jsh.pad_leading_axis({k: jnp.asarray(v)
                                     for k, v in tree.items()}, multiple)
        for k in tree:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got[k].shape[0] % multiple == 0
        back = sh.slice_leading_axis(got, 5)
        for k in tree:
            np.testing.assert_array_equal(back[k].numpy(), tree[k])


def test_leading_block():
    assert sh.leading_block(6, 2, 1) == slice(3, 6)
    assert sh.leading_block(4, 4, 0) == slice(0, 1)
    with pytest.raises(ValueError, match="do not split"):
        sh.leading_block(5, 2, 0)


# ---------------------------------------------------------------------------
# ranks: world 2 (meshes, gathers) and world 4 (meshes)
# ---------------------------------------------------------------------------
_MESHES = r"""
from repro_torch.launch import mesh as M


def desc(m):
    return None if m is None else [list(m.mesh_dim_names), list(m.shape)]


def err(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


out = {"rank": RANK, "world": M.world_size(),
       "sweep": desc(M.make_sweep_mesh(device="cpu")),
       "sweep1": desc(M.make_sweep_mesh(1, device="cpu")),
       "pop": desc(M.make_population_mesh(device="cpu")),
       "pop_s": desc(M.make_population_mesh(n_scenario=WORLD // 2,
                                            device="cpu")),
       "pop_c": desc(M.make_population_mesh(n_clients=1, device="cpu")),
       "pop_bad": err(lambda: M.make_population_mesh(3, 2, device="cpu")),
       "prod": err(lambda: M.make_production_mesh(device="cpu"))}
dbg = M.make_debug_mesh(1, WORLD, device="cpu")
out["debug"] = desc(dbg)
out["debug_axes"] = [list(M.data_axes(dbg)), M.n_data_shards(dbg)]
"""

_GATHERS = r"""
import numpy as np
from repro_torch.data.partition import synthetic_population
from repro_torch.fl.fused_round import _gather_rows
from repro_torch.launch.sharding import gather_leading, leading_block

g = dist.group.WORLD
rng = np.random.default_rng(0)
store = synthetic_population(8, 3, {"a": (2, 3), "b": (4,)}, 5, 0.3, seed=1)
leaves = store.leaves()
x = torch.as_tensor(rng.standard_normal((8, 3)).astype(np.float32))
x[2, 1] = -0.0                                  # a signed zero crosses
leaves.append(x)
leaves.append(torch.as_tensor(rng.integers(0, 2 ** 31, 8)))    # int64
blk = leading_block(8, WORLD, RANK)
ok = True
for cohort in ([5, 0, 7], [1, 2, 3, 4], [6]):
    idx = torch.as_tensor(cohort)
    for leaf in leaves:
        full = torch.as_tensor(np.asarray(leaf))
        got = _gather_rows(full[blk], idx, g)
        want = full.index_select(0, idx)
        ok &= got.dtype == want.dtype and got.shape == want.shape
        ok &= bool((got.view(torch.uint8) == want.view(torch.uint8)).all()
                   if got.dtype.is_floating_point else torch.equal(got, want))
tiled = True
for leaf in leaves:
    full = torch.as_tensor(np.asarray(leaf))
    got = gather_leading(full[blk], g)
    tiled &= got.dtype == full.dtype and bool(
        (got.view(torch.uint8) == full.view(torch.uint8)).all()
        if got.dtype.is_floating_point else torch.equal(got, full))
out["gather_rows_exact"] = bool(ok)
out["gather_leading_exact"] = bool(tiled)
out["signed_zero"] = bool(torch.signbit(gather_leading(x[blk], g)[2, 1]))
emit(out)
"""


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Both launches, started as the file starts: the single-process tests
    run while the ranks do."""
    started = {2: Ranks(_MESHES + _GATHERS, 2,
                        tmp_path_factory.mktemp("mesh2")),
               4: Ranks(_MESHES + "emit(out)\n", 4,
                        tmp_path_factory.mktemp("mesh4"))}
    yield started
    for r in started.values():
        r.close()


@pytest.fixture(scope="module")
def world2(ranks):
    return ranks[2].results()


@pytest.fixture(scope="module")
def world4(ranks):
    return ranks[4].results()


def test_world2_meshes(world2):
    for out in world2:
        assert out["world"] == 2
        assert out["sweep"] == [["scenario"], [2]]
        assert out["sweep1"] is None
        assert out["pop"] == [["scenario", "clients"], [1, 2]]
        assert out["pop_s"] == [["scenario", "clients"], [1, 2]]
        assert out["pop_c"] == [["scenario", "clients"], [2, 1]]
        assert out["pop_bad"] == "mesh 3x2 needs 6 devices, have 2"
        assert "of 256 ranks, have 2" in out["prod"]
        assert out["debug"] == [["data", "model"], [1, 2]]
        assert out["debug_axes"] == [["data"], 1]


def test_world4_meshes(world4):
    for out in world4:
        assert out["world"] == 4
        assert out["sweep"] == [["scenario"], [4]]
        assert out["pop"] == [["scenario", "clients"], [1, 4]]
        assert out["pop_s"] == [["scenario", "clients"], [2, 2]]
        assert out["pop_c"] == [["scenario", "clients"], [4, 1]]
        assert out["pop_bad"] == "mesh 3x2 needs 6 devices, have 4"
        assert out["debug"] == [["data", "model"], [1, 4]]


def test_gathers_are_exact(world2):
    """Float, int and bool leaves of a store, a float leaf with a ``-0.0``
    and an int64 leaf: the cohort gather equals ``index_select`` and the
    tiled reassembly the whole leaf, bit for bit, on both ranks."""
    for out in world2:
        assert out["gather_rows_exact"]
        assert out["gather_leading_exact"]
        assert out["signed_zero"]
