"""The port's sharded sweeps (``FusedRoundEngine.scan_scenario_grid`` /
``scan_v_grid`` on a ``DeviceMesh``) against its own one-device sweeps and
the JAX package's, and ``ContinuousServer(mesh=)`` against the unsharded
server.

Ranks are subprocesses on a gloo group (``tests/_torch_ranks.py``), as the
JAX package's mesh tests run theirs (``tests/test_sharded_sweep.py``,
``tests/test_cohort_gather.py``), at those tests' configurations on the
CPU: iemocap with JCSBA, the port on the JAX package's initial params and
``jax.random`` bits with ``dropout=0.0`` (``_torch_jax_parity.pair``),
and a small immune search with 12-step bisections on both sides to keep
the CPU solver quick.

* 1-D ``("scenario",)`` on 2 ranks (``mesh="auto"``): K=6, n=120, 3
  rounds, V = [0.01, 0.1, 1.0, 10.0, 3.0] — five rows on two ranks, so the
  grid is padded;
* 2-D ``("scenario", "clients")`` 2×2 on 4 ranks: K=10, n=150, V =
  [0.01, 0.3, 2.0] — the store split over the clients axis;
* a 3-row ``scan_scenario_grid`` with per-scenario stores and test
  splits on 2 ranks.

Every leaf equals the port's one-device sweep, or lies within rtol 2e-6 /
atol 1e-7 (the JAX tests' own tolerance); against the JAX package's
one-device ``scan_v_grid`` the tolerances of ``tests/test_torch_
scenarios.py`` hold (``a``/``ok`` identical, Q and spent within rtol 1e-5
/ atol 1e-9).  The error paths keep the JAX package's words.
"""
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_jax_parity import pair
from _torch_ranks import Ranks
from repro.fl.fused_round import draw_round_xs as j_draw_round_xs
from repro.fl.runtime import parse_engine as j_parse_engine
from repro_torch.core.trees import tree_leaves
from repro_torch.data.scenarios import ScenarioSpec, stack_scenarios
from repro_torch.fl.client import make_adapter
from repro_torch.fl.fused_round import (FusedRoundEngine, draw_population_xs,
                                        draw_round_xs)
from repro_torch.wireless.channel import Channel
from repro_torch.wireless.params import WirelessParams
from repro_torch.wireless.policies import JCSBAPolicy
from repro_torch.wireless.solver import SolverHyper
from test_torch_scenarios import _assert_grid_match

HP = dict(S=6, G=2, n_bisect_b=12, n_bisect_k=12)
ENGINE = "fused"
ROUNDS = 3
V_1D = [0.01, 0.1, 1.0, 10.0, 3.0]
V_2D = [0.01, 0.3, 2.0]
GRID_PARAMS = WirelessParams(K=6, B_max=6e6, E_add=2e-4)
GRID_SPECS = [dict(dataset="iemocap", K=6, n_per_client=4, n_test=16,
                   split=s, omega=w, noise_sigma=ns, seed=i)
              for i, (s, w, ns) in enumerate((("iid", 0.0, 0.0),
                                              ("dirichlet", 0.3, 0.0),
                                              ("iid", 0.6, 0.5)))]

#: the rank program's shared part: the port's experiment of a ``pair``,
#: rebuilt from the inputs the test wrote (params, carry, xs)
_RANK_SETUP = r"""
import numpy as np
from repro_torch.fl.client import make_adapter
from repro_torch.fl.runtime import MFLExperiment
from repro_torch.launch import mesh as M

inp = torch.load(TMP / "inputs.pt", weights_only=False)
exp = MFLExperiment(**inp["exp_kw"])
exp.adapter = make_adapter(**inp["adapter_kw"])
exp.global_params, exp.init_params = inp["global"], inp["init"]
eng = exp._get_fused_engine()
carry, xs = inp["carry"], inp["xs"]
"""

_TWO_RANKS = _RANK_SETUP + r"""
from repro_torch.core.trees import tree_map
from repro_torch.data.scenarios import ScenarioSpec, stack_scenarios
from repro_torch.fl.fused_round import FusedRoundEngine
from repro_torch.wireless.policies import JCSBAPolicy
from repro_torch.wireless.solver import SolverHyper

out = {"rank": RANK}
# 1-D ("scenario",) sweep through the "auto" mesh over the group
v1d = eng.scan_v_grid(inp["V"], carry, xs, mesh="auto")
torch.save(v1d, TMP / f"v1d_{RANK}.pt")

# a scenario grid with per-scenario stores and test splits
g = inp["grid"]
grid = stack_scenarios([ScenarioSpec(**k) for k in g["specs"]], g["params"])
geng = FusedRoundEngine.from_store(
    grid.store_row(0), g["params"],
    JCSBAPolicy(6, SolverHyper(**g["hp"]), max_cohort=3),
    make_adapter("iemocap", "lstm-cnn", dropout=0.0), device="cpu")
geng._global_params0 = geng._init_params = g["gp"]
sweep_mesh = M.make_sweep_mesh(device="cpu")
grid_out = geng.scan_scenario_grid(
    grid.overrides, geng.fresh_carry(), g["xs"], stores=grid.stores,
    test_sets=(grid.test_features, grid.test_labels), mesh=sweep_mesh)
torch.save(grid_out, TMP / f"grid_{RANK}.pt")

# a ("scenario", "clients") mesh is V-grid-only
try:
    eng.scan_scenario_grid({"V": np.ones(2)}, carry, xs,
                           mesh=M.make_population_mesh(device="cpu"))
    out["clients_mesh_error"] = None
except ValueError as e:
    out["clients_mesh_error"] = str(e)

# the continuous server on the mesh against the unsharded one, before and
# after a hot swap of the sweep's first row's params
from repro_torch.configs import get_config
from repro_torch.launch import steps as S
from repro_torch.launch.continuous import ContinuousServer
cfg = get_config("qwen3-0.6b").reduced()
lm = S.init_fn(cfg)(torch.Generator().manual_seed(0))
feats = {m: x[:2] for m, x in sorted(exp.test_ds.features.items())}
servers = [ContinuousServer(cfg, lm, exp.global_params, feats, max_len=24,
                            mesh=sweep_mesh, device="cpu"),
           ContinuousServer(cfg, lm, exp.global_params, feats, max_len=24,
                            device="cpu")]
prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
tokens = [[], []]
for s in servers:
    s.start(prompts)
new = tree_map(lambda x: x[0], v1d[0].params)
for phase in range(2):
    if phase:
        for s in servers:
            s.swap(new)
    for _ in range(4):
        for k, s in enumerate(servers):
            s.decode_step()
            tokens[k].append(s.token.reshape(-1).tolist())
out["tokens_mesh"], out["tokens_plain"] = tokens
from repro_torch.core.trees import tree_leaves
from torch.distributed.tensor import Replicate
out["replicated"] = all(isinstance(p, Replicate) and len(ps) == 1
                        for ps in tree_leaves(servers[0].placements)
                        for p in ps)
emit(out)
"""

_FOUR_RANKS = _RANK_SETUP + r"""
out = {"rank": RANK}
mesh = M.make_population_mesh(n_scenario=2, n_clients=2, device="cpu")
out["coordinate"] = mesh.get_coordinate()
v2d = eng.scan_v_grid(inp["V"], carry, xs, mesh=mesh)
torch.save(v2d, TMP / f"v2d_{RANK}.pt")
twin = eng._client_twins[mesh]
out["store_rows"] = int(twin._store.labels.shape[0])
out["round_body"] = twin.round_body
try:
    eng.scan_v_grid(inp["V"], carry, xs,
                    mesh=M.make_population_mesh(n_scenario=1, device="cpu"))
    out["k_error"] = None
except ValueError as e:
    out["k_error"] = str(e)
emit(out)
"""


def _pair_inputs(tmp, K, n, V):
    """Both packages' experiments (JCSBA, the small search) and xs, and the
    port's side written for the ranks; returns (j, t, jxs, txs)."""
    skw = {"immune_kwargs": HP}
    j, t = pair("iemocap", ENGINE, "jcsba", skw, K=K, n_samples=n, seed=0,
                eval_every=10 ** 9)
    j._get_fused_engine()
    t._get_fused_engine()
    jxs, txs = j_draw_round_xs(j, ROUNDS), draw_round_xs(t, ROUNDS)
    np.testing.assert_array_equal(txs.h.numpy(), np.asarray(jxs.h))
    _, _, loss, remat, kernels, _ = j_parse_engine(ENGINE)
    torch.save({
        "exp_kw": dict(dataset="iemocap", engine=ENGINE, scheduler="jcsba",
                       scheduler_kwargs=skw, K=K, n_samples=n, seed=0,
                       eval_every=10 ** 9, device="cpu"),
        "adapter_kw": dict(dataset_name="iemocap", arch="lstm-cnn",
                           dropout=0.0,
                           loss_backend=loss, remat=remat,
                           use_kernels=kernels),
        "global": t.global_params, "init": t.init_params,
        "carry": t._carry, "xs": txs, "V": V}, tmp / "inputs.pt")
    return j, t, jxs, txs


def _grid_inputs():
    """The stores grid, its engine (on the port's own initial params,
    passed to the ranks) and its xs."""
    grid = stack_scenarios([ScenarioSpec(**k) for k in GRID_SPECS],
                           GRID_PARAMS)
    pol = JCSBAPolicy(6, SolverHyper(**HP), max_cohort=3)
    eng = FusedRoundEngine.from_store(
        grid.store_row(0), GRID_PARAMS, pol,
        make_adapter("iemocap", "lstm-cnn", dropout=0.0), device="cpu")
    rng = np.random.default_rng(1)
    xs = draw_population_xs(Channel(GRID_PARAMS, rng), rng, 6, ROUNDS,
                            eval_every=2, include_final=True, policy=pol,
                            device="cpu")
    return grid, eng, xs, eng._global_params0


def _assert_equal_or_close(a, b):
    """Every leaf of ``a`` equal to ``b``'s, or within rtol 2e-6 / atol
    1e-7; bool and integer leaves equal."""
    la, lb = (tree_leaves(t[0]) + tree_leaves(t[1]) for t in (a, b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, y.shape)
        if x.dtype.is_floating_point:
            if not torch.equal(x, y):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-6,
                                           atol=1e-7)
        else:
            assert torch.equal(x, y)


def _load(tmp, name, world):
    return [torch.load(tmp / f"{name}_{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_ranks")
    j, t, jxs, txs = _pair_inputs(tmp, 6, 120, V_1D)
    grid, geng, gxs, gp = _grid_inputs()
    inp = torch.load(tmp / "inputs.pt", weights_only=False)
    inp["grid"] = {"specs": GRID_SPECS, "params": GRID_PARAMS, "hp": HP,
                   "gp": gp, "xs": gxs}
    torch.save(inp, tmp / "inputs.pt")
    ranks = Ranks(_TWO_RANKS, 2, tmp)
    try:      # the references, while the ranks run
        single = t._get_fused_engine().scan_v_grid(V_1D, t._carry, txs,
                                                   mesh=None)
        kw = dict(stores=grid.stores,
                  test_sets=(grid.test_features, grid.test_labels))
        grid_single = geng.scan_scenario_grid(
            grid.overrides, geng.fresh_carry(), gxs, mesh=None, **kw)
        jax_ref = j._get_fused_engine().scan_v_grid(V_1D, j._carry, jxs,
                                                    mesh=None)
    except BaseException:
        ranks.close()
        raise
    return dict(tmp=tmp, outs=ranks.results(), single=single,
                grid_single=grid_single, jax_ref=jax_ref)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four_ranks")
    j, t, jxs, txs = _pair_inputs(tmp, 10, 150, V_2D)
    ranks = Ranks(_FOUR_RANKS, 4, tmp)
    try:      # the references, while the ranks run
        single = t._get_fused_engine().scan_v_grid(V_2D, t._carry, txs,
                                                   mesh=None)
        jax_ref = j._get_fused_engine().scan_v_grid(V_2D, j._carry, jxs,
                                                    mesh=None)
    except BaseException:
        ranks.close()
        raise
    return dict(tmp=tmp, outs=ranks.results(), single=single,
                jax_ref=jax_ref)


def test_1d_sweep_matches_single_device(two_ranks):
    """Five V rows padded to six on two ranks: every rank gets the whole
    grid back, equal to the one-device sweep; the V axis differentiates
    the rows."""
    for got in _load(two_ranks["tmp"], "v1d", 2):
        _assert_equal_or_close(got, two_ranks["single"])
        carries, auxs = got
        assert auxs.J.shape == (5, ROUNDS) and carries.Q.shape == (5, 6)
        assert len(set(np.round(auxs.J[:, 0].numpy(), 8))) > 1


def test_1d_sweep_matches_jax(two_ranks):
    _assert_grid_match(_load(two_ranks["tmp"], "v1d", 2)[0],
                       two_ranks["jax_ref"])


def test_scenario_grid_with_stores_matches_single_device(two_ranks):
    """Three rows with their own stores and test splits, padded to four on
    two ranks, each rank's block through its own rounds."""
    for got in _load(two_ranks["tmp"], "grid", 2):
        _assert_equal_or_close(got, two_ranks["grid_single"])
        assert got[1].metrics["multimodal"].shape == (3, ROUNDS)


def test_clients_mesh_refused_by_scenario_grid(two_ranks):
    for out in two_ranks["outs"]:
        assert out["clients_mesh_error"] == (
            "scan_scenario_grid supports 1-D ('scenario',) meshes only; "
            "the 2-D ('scenario', 'clients') population mesh shards the "
            "client store itself — run V-only grids there via scan_v_grid")


def test_continuous_server_on_mesh_matches_unsharded(two_ranks):
    """Replicated buffers: the same tokens as the unsharded server before
    and after a hot swap, on both ranks."""
    outs = two_ranks["outs"]
    for out in outs:
        assert out["tokens_mesh"] == out["tokens_plain"]
        assert out["replicated"]
    assert outs[0]["tokens_mesh"] == outs[1]["tokens_mesh"]
    assert outs[0]["tokens_mesh"][:4] != outs[0]["tokens_mesh"][4:]


def test_2d_sweep_matches_single_device(four_ranks):
    """2×2 ("scenario", "clients"): each rank holds five of the ten
    clients' rows and runs the round eagerly (gloo); three V rows padded
    to four."""
    outs = four_ranks["outs"]
    assert [o["coordinate"] for o in outs] == [[0, 0], [0, 1], [1, 0],
                                               [1, 1]]
    for out in outs:
        assert out["store_rows"] == 5 and out["round_body"] == "eager"
    for got in _load(four_ranks["tmp"], "v2d", 4):
        _assert_equal_or_close(got, four_ranks["single"])
        assert got[1].a.shape == (3, ROUNDS, 10)


def test_2d_sweep_matches_jax(four_ranks):
    _assert_grid_match(_load(four_ranks["tmp"], "v2d", 4)[0],
                       four_ranks["jax_ref"])


def test_clients_axis_must_divide_k(four_ranks):
    for out in four_ranks["outs"]:
        assert out["k_error"] == ("K=10 must divide the mesh's clients "
                                  "axis (4 shards)")

