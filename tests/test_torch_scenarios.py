"""The port's scenario axis (``data/scenarios.py`` and the fused round's
``scan_scenario_grid``/``scan_v_grid``) against the JAX package's.

The scenario library is numpy on both sides: for the same spec the port's
stores, test splits, solver-data override rows and ``population_costs``
equal the JAX package's bit for bit.  The spec checks and the
``build_scenario`` properties of ``tests/test_scenarios.py`` are mirrored
on the port's copy.

The grids run at the JAX tests' tiny geometry (iemocap, K=6, 4 samples a
client, 16 test samples, 3 rows, 3 rounds, JCSBA with a cohort of 3 and a
small immune search).  On the CPU the port sweeps a grid with the body run
eagerly on swapped-in buffers (a card replays one captured round; the
``gpu`` tests in ``tests/test_torch_isolation.py`` hold those replays
against this body).  Against the JAX package's single-device sweep, on its
initial params and ``jax.random`` bits with ``dropout=0.0``: participants
and ``ok`` identical, Q and spent within rtol 1e-5 / atol 1e-9, metrics
within 1e-5, params, ζ, δ and model_dist within 1e-4 — the tolerances of
``tests/test_torch_fused_round.py``.
"""
import collections

import jax
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_jax_parity import jax_draw_source
from repro.data import scenarios as jsc
from repro.fl.client import make_adapter as j_make_adapter
from repro.fl.fused_round import FusedRoundEngine as JEngine
from repro.fl.fused_round import draw_population_xs as j_draw_xs
from repro.wireless import cost as jcost
from repro.wireless.channel import Channel as JChannel
from repro.wireless.params import MODALITY_PROFILES as J_PROFILES
from repro.wireless.params import WirelessParams as JParams
from repro.wireless.policies import JCSBAPolicy as JJCSBA
from repro.wireless.solver import SolverHyper as JHyper
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.trees import tree_leaves, tree_map
from repro_torch.data.partition import ClientStore, missing_counts
from repro_torch.data.scenarios import (DATASET_SHAPES, SPLIT_LAWS,
                                        ScenarioSpec, build_scenario,
                                        scenario_overrides, stack_scenarios)
from repro_torch.fl.client import make_adapter
from repro_torch.fl.fused_round import (FusedRoundEngine, draw_population_xs,
                                        draw_round_xs)
from repro_torch.fl.runtime import MFLExperiment
from repro_torch.wireless import cost as tcost
from repro_torch.wireless.channel import Channel
from repro_torch.wireless.params import MODALITY_PROFILES, WirelessParams
from repro_torch.wireless.policies import JCSBAPolicy
from repro_torch.wireless.solver import SolverHyper

PARAMS = WirelessParams(K=6, B_max=6e6, E_add=2e-4)
J_PARAMS = JParams(K=6, B_max=6e6, E_add=2e-4)
GEOM = dict(dataset="iemocap", K=6, n_per_client=4, n_test=16)
HP = dict(S=6, G=2)
ROUNDS, EVAL_EVERY = 3, 2
#: the corruption models of a spec: feature noise, erased sample blocks, a
#: deployment-time missing test modality
CORRUPTIONS = {"noise": dict(noise_sigma=0.5),
               "erasure": dict(erasure_rate=0.3),
               "test_missing": dict(test_missing="text")}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _same(a, b) -> bool:
    """Bitwise, dtype included, NaN equal to NaN."""
    a, b = _np(a), _np(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        return np.array_equal(a, b, equal_nan=True)
    return np.array_equal(a, b)


def _assert_store_equal(t, j):
    assert t.modalities == tuple(j.modalities)
    for f in ("labels", "sample_mask", "sizes", "gamma_bits", "tau_cmp",
              "e_cmp"):
        assert _same(getattr(t, f), getattr(j, f)), f
    for f in ("features", "has_modality"):
        tv, jv = getattr(t, f), getattr(j, f)
        assert sorted(tv) == sorted(jv)
        for m in tv:
            assert _same(tv[m], jv[m]), (f, m)


# ---------------------------------------------------------------------------
# spec validation (tests/test_scenarios.py, on the port's copy)
# ---------------------------------------------------------------------------
def test_spec_validation_errors():
    with pytest.raises(ValueError):
        ScenarioSpec(dataset="mosei")
    with pytest.raises(ValueError):
        ScenarioSpec(split="pathological")
    with pytest.raises(ValueError):
        ScenarioSpec(split="dirichlet", alpha=0.0)
    with pytest.raises(ValueError):
        ScenarioSpec(split="natural", n_groups=0)
    with pytest.raises(ValueError):
        ScenarioSpec(erasure_rate=1.5)
    with pytest.raises(ValueError):
        ScenarioSpec(test_missing="video")
    with pytest.raises(ValueError):
        ScenarioSpec(omega=1.0)                 # normalize-at-construction
    with pytest.raises(ValueError):
        ScenarioSpec(arch="moe")                # the port's FL_ARCHS


def test_spec_normalizes_omega_snr_to_tuples():
    s = ScenarioSpec(omega={"text": 0.4}, snr=2.0)
    assert s.omega == (0.0, 0.4)                # sorted: (audio, text)
    assert s.snr == (2.0, 2.0)
    assert s.modalities == ("audio", "text")
    assert "om=0/0.4" in s.label()
    assert ScenarioSpec(name="zed").label() == "zed"
    assert "transformer" in ScenarioSpec(arch="transformer").label()


# ---------------------------------------------------------------------------
# build_scenario properties
# ---------------------------------------------------------------------------
def test_build_scenario_ownership_matches_missing_counts():
    for omega in (0.0, 0.3, 0.6, (0.6, 0.2)):
        spec = ScenarioSpec(omega=omega, **GEOM)
        store, tf, tl = build_scenario(spec, PARAMS)
        counts = missing_counts(spec.K, spec.omega)
        for i, m in enumerate(spec.modalities):
            has = np.asarray(store.has_modality[m])
            assert int((~has).sum()) == counts[i], (omega, m)
        has_all = np.stack([np.asarray(store.has_modality[m])
                            for m in spec.modalities])
        assert has_all.any(axis=0).all()
        assert (np.asarray(store.gamma_bits)[has_all.any(axis=0)] > 0).all()


def test_build_scenario_shapes_and_labels():
    spec = ScenarioSpec(**GEOM)
    store, tf, tl = build_scenario(spec, PARAMS)
    shapes, C = DATASET_SHAPES["iemocap"]
    for m, shape in shapes.items():
        assert np.asarray(store.features[m]).shape == (6, 4) + shape
        assert tf[m].shape == (16,) + shape
    y = np.asarray(store.labels)
    assert y.shape == (6, 4) and y.min() >= 0 and y.max() < C
    assert tl.shape == (16,) and tl.max() < C


def test_dirichlet_split_skews_labels():
    C = DATASET_SHAPES["iemocap"][1]

    def mean_client_label_diversity(split, alpha):
        spec = ScenarioSpec(split=split, alpha=alpha, omega=0.0,
                            dataset="iemocap", K=8, n_per_client=64,
                            n_test=8, seed=1)
        y = np.asarray(build_scenario(spec, PARAMS)[0].labels)
        return np.mean([len(set(r.tolist())) for r in y])

    iid = mean_client_label_diversity("iid", 0.5)
    skew = mean_client_label_diversity("dirichlet", 0.1)
    assert iid > 0.8 * C
    assert skew < 0.6 * iid


def test_natural_split_group_structure():
    spec = ScenarioSpec(split="natural", alpha=100.0, n_groups=2,
                        group_sigma=4.0, omega=0.0, dataset="iemocap",
                        K=8, n_per_client=16, n_test=8, seed=2)
    x = np.asarray(build_scenario(spec, PARAMS)[0].features["audio"])
    mu = x.mean(axis=1).reshape(8, -1)
    groups = (np.arange(8) * 2) // 8
    d = np.linalg.norm(mu[:, None] - mu[None], axis=-1)
    within = d[groups[:, None] == groups[None]].mean()
    across = d[groups[:, None] != groups[None]].mean()
    assert across > 2 * within


def test_erasure_zeroes_sample_blocks():
    spec = ScenarioSpec(erasure_rate=0.5, omega=0.0, dataset="iemocap",
                        K=8, n_per_client=32, n_test=8, seed=3)
    store = build_scenario(spec, PARAMS)[0]
    for m in spec.modalities:
        x = np.asarray(store.features[m]).reshape(8, 32, -1)
        dead = ~np.abs(x).sum(-1).astype(bool)
        assert 0.3 < dead.mean() < 0.7, (m, dead.mean())


def test_test_missing_zeroes_only_that_test_modality():
    spec = ScenarioSpec(test_missing="text", omega=0.0, **GEOM)
    store, tf, tl = build_scenario(spec, PARAMS)
    assert not tf["text"].any()
    assert tf["audio"].any()
    assert np.asarray(store.features["text"]).any()


def test_features_carry_class_signal():
    spec = ScenarioSpec(omega=0.0, snr=2.0, dataset="iemocap", K=4,
                        n_per_client=128, n_test=8, seed=4)
    store = build_scenario(spec, PARAMS)[0]
    x = np.asarray(store.features["audio"]).reshape(4 * 128, -1)
    y = np.asarray(store.labels).reshape(-1)
    mus = np.stack([x[y == c].mean(axis=0) for c in range(spec.n_classes)
                    if (y == c).sum() > 5])
    spread = np.linalg.norm(mus - mus.mean(0), axis=-1)
    assert spread.min() > 1.0


def test_stack_scenarios_shapes_and_geometry_check():
    specs = [ScenarioSpec(omega=w, seed=i, **GEOM)
             for i, w in enumerate((0.0, 0.3, 0.6))]
    grid = stack_scenarios(specs, PARAMS)
    assert grid.n == 3
    assert np.asarray(grid.stores.labels).shape == (3, 6, 4)
    assert grid.test_labels.shape == (3, 16)
    assert grid.overrides["V"].shape == (3,)
    assert grid.overrides["has"].shape == (3, 2, 6)
    assert grid.overrides["tau_cmp"].shape == (3, 6)
    row = grid.store_row(1)
    assert np.asarray(row.labels).shape == (6, 4)
    with pytest.raises(ValueError):
        stack_scenarios([], PARAMS)
    with pytest.raises(ValueError):
        stack_scenarios([specs[0],
                         ScenarioSpec(dataset="iemocap", K=8,
                                      n_per_client=4, n_test=16)], PARAMS)


def test_client_store_stack_and_row_round_trip():
    """``ClientStore.stack`` gives [S]-leading leaves, ``row`` takes one
    back out; a CPU ``to`` wraps the numpy leaves, and an engine built
    ``from_store`` keeps a copy that shares no memory with them (a grid
    swaps rows into it)."""
    stores = [build_scenario(ScenarioSpec(seed=i, **GEOM), PARAMS)[0]
              for i in range(3)]
    st = ClientStore.stack(stores)
    assert st.features["text"].shape == (3, 6, 4, 24, 100)
    for s in range(3):
        for a, b in zip(st.row(s).leaves(), stores[s].leaves()):
            assert _same(a, b)
    wrapped = st.to("cpu")
    wrapped.labels[0, 0, 0] += 1
    assert _same(wrapped.labels, st.labels)
    eng = FusedRoundEngine.from_store(
        stores[1], PARAMS, JCSBAPolicy(6, SolverHyper(**HP), max_cohort=3),
        make_adapter("iemocap", "lstm-cnn", dropout=0.0), device="cpu")
    for a, b in zip(stores[1].leaves(), eng._store.leaves()):
        assert _same(a, b) and not np.shares_memory(a, b.numpy())


# ---------------------------------------------------------------------------
# bit for bit against the JAX package
# ---------------------------------------------------------------------------
def _spec_pair(**kw):
    return ScenarioSpec(**kw), jsc.ScenarioSpec(**kw)


@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
@pytest.mark.parametrize("split", SPLIT_LAWS)
def test_build_scenario_equals_jax(split, corruption):
    """Same spec, same numpy stream: store, test split and the override
    row equal the JAX package's bit for bit."""
    kw = dict(GEOM, split=split, alpha=0.4, n_groups=3, group_sigma=1.5,
              omega=(0.5, 0.2), snr=(1.5, 0.8), V=3.0, seed=11,
              **CORRUPTIONS[corruption])
    t, j = _spec_pair(**kw)
    (ts, ttf, ttl), (js, jtf, jtl) = (build_scenario(t, PARAMS),
                                      jsc.build_scenario(j, J_PARAMS))
    _assert_store_equal(ts, js)
    assert sorted(ttf) == sorted(jtf)
    for m in ttf:
        assert _same(ttf[m], jtf[m]), m
    assert _same(ttl, jtl)
    to, jo = (scenario_overrides(ts, PARAMS, t.V),
              jsc.scenario_overrides(js, J_PARAMS, j.V))
    assert sorted(to) == sorted(jo)
    for k in to:
        assert _same(to[k], jo[k]), k
    assert t.label() == j.label()


def test_stack_scenarios_equals_jax():
    rows = [dict(split="iid", omega=0.0), dict(split="dirichlet", omega=0.3,
                                                noise_sigma=0.4),
            dict(split="natural", omega=(0.6, 0.2), erasure_rate=0.2),
            dict(split="iid", omega=0.5, test_missing="audio", V=10.0)]
    pairs = [_spec_pair(seed=i, **GEOM, **r) for i, r in enumerate(rows)]
    tg = stack_scenarios([p[0] for p in pairs], PARAMS)
    jg = jsc.stack_scenarios([p[1] for p in pairs], J_PARAMS)
    assert tg.n == jg.n == 4
    _assert_store_equal(tg.stores, jg.stores)
    for k in jg.overrides:
        assert _same(tg.overrides[k], jg.overrides[k]), k
    assert sorted(tg.overrides) == sorted(jg.overrides)
    for m in jg.test_features:
        assert _same(tg.test_features[m], jg.test_features[m]), m
    assert _same(tg.test_labels, jg.test_labels)
    _assert_store_equal(tg.store_row(2), jg.store_row(2))
    assert [s.label() for s in tg.specs] == [s.label() for s in jg.specs]


@pytest.mark.parametrize("dataset", sorted(DATASET_SHAPES))
def test_population_costs_equals_jax(dataset):
    rng = np.random.default_rng(5)
    mods = tuple(sorted(DATASET_SHAPES[dataset][0]))
    K = 40
    has = {m: rng.random(K) < 0.7 for m in mods}
    has[mods[0]][:3] = False
    has[mods[1]][:2] = False                    # two clients own nothing
    sizes = rng.integers(1, 300, K).astype(np.float64)
    t = tcost.population_costs(has, mods, sizes, MODALITY_PROFILES[dataset],
                               WirelessParams(K=K))
    j = jcost.population_costs(has, mods, sizes, J_PROFILES[dataset],
                               JParams(K=K))
    for f in ("gamma_bits", "tau_cmp", "e_cmp"):
        assert _same(getattr(t, f), getattr(j, f)), f
    assert (t.gamma_bits[:2] == 0).all() and (t.tau_cmp[:2] == 0).all()


# ---------------------------------------------------------------------------
# the sweeps against the JAX package's single-device sweep
# ---------------------------------------------------------------------------
GRID_ROWS = (("iid", 0.0, 0.0), ("dirichlet", 0.3, 0.0), ("iid", 0.6, 0.5))


def _grids(arch="lstm-cnn", rows=GRID_ROWS):
    kw = [dict(split=s, omega=w, noise_sigma=ns, seed=i, arch=arch, **GEOM)
          for i, (s, w, ns) in enumerate(rows)]
    return (stack_scenarios([ScenarioSpec(**k) for k in kw], PARAMS),
            jsc.stack_scenarios([jsc.ScenarioSpec(**k) for k in kw],
                                J_PARAMS))


def _engines(tgrid, jgrid, arch="lstm-cnn", rounds=ROUNDS):
    """Both packages' engines on scenario 0's store, the port on the JAX
    package's initial params, and both packages' xs from one numpy stream
    (the port's policy bits made as the JAX package draws them)."""
    jeng = JEngine.from_store(
        jgrid.store_row(0), J_PARAMS, JJCSBA(6, JHyper(**HP), max_cohort=3),
        j_make_adapter("iemocap", arch, dropout=0.0), seed=0)
    pol = JCSBAPolicy(6, SolverHyper(**HP), max_cohort=3)
    teng = FusedRoundEngine.from_store(
        tgrid.store_row(0), PARAMS, pol,
        make_adapter("iemocap", arch, dropout=0.0), device="cpu")
    gp = params_from_numpy(jax.tree.map(np.asarray, jeng._global_params0),
                           "cpu")
    teng._global_params0 = teng._init_params = gp
    return (jeng, teng) + _xs(teng.policy, rounds)


def _xs(policy, rounds):
    """Both packages' xs for ``rounds`` rounds from one numpy stream."""
    rng = np.random.default_rng(1)
    jxs = j_draw_xs(JChannel(J_PARAMS, rng), rng, 6, rounds,
                    eval_every=EVAL_EVERY, include_final=True)
    rng = np.random.default_rng(1)
    txs = draw_population_xs(Channel(PARAMS, rng), rng, 6, rounds,
                             eval_every=EVAL_EVERY, include_final=True,
                             policy=policy, device="cpu",
                             draw_source=jax_draw_source)
    assert _same(txs.h, jxs.h) and _same(txs.eval_flag, jxs.eval_flag)
    return jxs, txs


def _assert_grid_match(t, j):
    (tc, ta), (jc, ja) = t, jax.tree.map(np.asarray, j)
    assert _same(ta.ok, ja.ok) and _same(ta.a, ja.a)
    assert _same(ta.eval_mask, ja.eval_mask)
    for m in ja.drop:
        assert _same(ta.drop[m], ja.drop[m]), m
    np.testing.assert_allclose(_np(tc.Q), jc.Q, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(_np(tc.spent), jc.spent, rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(_np(ta.energy_total), ja.energy_total,
                               rtol=1e-5, atol=1e-9)
    assert sorted(ta.metrics) == sorted(ja.metrics)
    for k in ja.metrics:
        np.testing.assert_allclose(_np(ta.metrics[k]), ja.metrics[k],
                                   atol=1e-5, err_msg=k)
    for m in ja.weights:
        np.testing.assert_allclose(_np(ta.weights[m]), ja.weights[m],
                                   rtol=1e-6, atol=1e-7, err_msg=m)
    tp = tree_leaves(params_to_numpy(tc.params))
    jp = jax.tree.leaves(jc.params)
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    for f in ("zeta", "delta", "model_dist"):
        np.testing.assert_allclose(_np(getattr(tc, f)), getattr(jc, f),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    assert _same(tc.policy["warm_a"], jc.policy["warm_a"])


@pytest.fixture(scope="module")
def lstm_grid():
    """The 3-row grid through both packages' sweeps, once for the file;
    the port's engine also takes one step of its own experiment first."""
    from repro_torch.fl.fused_round import tree_row
    tgrid, jgrid = _grids()
    jeng, teng, jxs, txs = _engines(tgrid, jgrid)
    kw_t = dict(stores=tgrid.stores,
                test_sets=(tgrid.test_features, tgrid.test_labels))
    kw_j = dict(stores=jgrid.stores,
                test_sets=(jgrid.test_features, jgrid.test_labels))
    before = teng.step(teng.fresh_carry(), tree_row(txs, 0))
    own = [t.clone() for t in _engine_buffers(teng)]
    t = teng.scan_scenario_grid(tgrid.overrides, teng.fresh_carry(), txs,
                                **kw_t)
    j = jeng.scan_scenario_grid(jgrid.overrides, jeng.fresh_carry(), jxs,
                                mesh=None, **kw_j)
    return collections.namedtuple(
        "LstmGrid", "tgrid jgrid jeng jxs teng txs kw_t before own t j")(
        tgrid, jgrid, jeng, jxs, teng, txs, kw_t, before, own, t, j)


def _engine_buffers(eng):
    """What a grid swaps or reads of the engine's own experiment: the
    solver template's device entries, the store, the held-out split."""
    return ([v for v in eng._solver_tmpl.values()
             if isinstance(v, torch.Tensor)] + eng._store.leaves()
            + list(eng._test_feats.values()) + [eng._test_labels])


def test_scenario_grid_matches_jax(lstm_grid):
    g = lstm_grid
    _assert_grid_match(g.t, g.j)
    carries, auxs = g.t
    assert auxs.metrics["multimodal"].shape == (3, ROUNDS)
    assert carries.Q.shape == (3, 6)
    ok = _np(auxs.ok)
    assert len({tuple(ok[s].sum(-1)) for s in range(3)}) > 1
    emask = _np(auxs.eval_mask)
    np.testing.assert_array_equal(emask[0], [True, False, True])
    assert np.isfinite(_np(auxs.metrics["multimodal"])[emask]).all()


def test_grid_replays_equal_the_body_with_arguments(lstm_grid):
    """A row of the swap loop equals that scenario's experiment run as
    ``_round_step(overrides=, test_set=)`` over its own store, passed as
    arguments, bit for bit."""
    g = lstm_grid
    carries, auxs = g.t
    s = 2
    ovr, store, test = g.teng._grid_row(g.tgrid.overrides, s, **g.kw_t)
    c, a = g.teng._scan_one_scenario(ovr, store, test,
                                     g.teng.fresh_carry(), g.txs)
    for x, y in zip(tree_leaves(c), tree_leaves(carries)):
        assert _same(x, y[s])
    for x, y in zip(tree_leaves(a), tree_leaves(auxs)):
        assert _same(x, y[s])


def test_grid_leaves_the_engine_step_unchanged(lstm_grid):
    """A grid puts the engine's buffers back: its own step on its own
    experiment gives what it gave before the grid, and its template,
    store and held-out split hold their values."""
    from repro_torch.fl.fused_round import tree_row
    g = lstm_grid
    for a, b in zip(g.own, _engine_buffers(g.teng)):
        assert _same(a, b)
    after = g.teng.step(g.teng.fresh_carry(), tree_row(g.txs, 0))
    for x, y in zip(g.before, after):
        for a, b in zip(tree_leaves(x), tree_leaves(y)):
            assert _same(a, b)


def test_scan_v_grid_is_the_scenario_grid_of_v(lstm_grid):
    g = lstm_grid
    V = [0.1, 10.0]
    xs = tree_map(lambda x: x[:1], g.txs)
    a = g.teng.scan_v_grid(V, g.teng.fresh_carry(), xs)
    b = g.teng.scan_scenario_grid({"V": np.asarray(V)},
                                  g.teng.fresh_carry(), xs)
    for x, y in zip(tree_leaves(a[0]) + tree_leaves(a[1]),
                    tree_leaves(b[0]) + tree_leaves(b[1])):
        assert _same(x, y)


def test_v_grid_rows_differ_and_match_jax(lstm_grid):
    """At E_add = 2e-4 the energy constraint binds and a queue grows, so
    a V small enough to weigh the bound below the queued energy moves the
    schedule (here from round 3 on): the rows differ, and each matches the
    JAX package's ``scan_v_grid``."""
    g = lstm_grid
    V = [1e-6, 1.0]
    jxs, txs = _xs(g.teng.policy, 4)
    t = g.teng.scan_v_grid(V, g.teng.fresh_carry(), txs)
    j = g.jeng.scan_v_grid(V, g.jeng.fresh_carry(), jxs, mesh=None)
    _assert_grid_match(t, j)
    assert (_np(t[0].Q) > 0).any()
    a = _np(t[1].a)
    assert not np.array_equal(a[0], a[1])


def test_grid_refuses_mismatched_overrides(lstm_grid):
    g = lstm_grid
    c = g.teng.fresh_carry()
    with pytest.raises(ValueError, match="scenario axis"):
        g.teng.scan_scenario_grid({"V": np.ones(3), "D": np.ones((2, 6))},
                                  c, g.txs)
    with pytest.raises(ValueError, match="no scenario axis"):
        g.teng.scan_scenario_grid({"V": np.float64(1.0)}, c, g.txs)
    with pytest.raises(ValueError, match="device entries"):
        g.teng.scan_scenario_grid({"B_max": np.ones(3)}, c, g.txs)
    with pytest.raises(ValueError, match="stores leaf"):
        g.teng.scan_scenario_grid(
            {"V": np.ones(2)}, c, g.txs, stores=g.tgrid.stores)


class FakeMesh:
    """A stand-in for a ``DeviceMesh``: axis names and sizes, no ranks."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names

    def size(self):
        return int(np.prod(self.shape))


@pytest.mark.parametrize("mesh", [
    FakeMesh((1, 4), ("scenario", "clients")),
    FakeMesh((1, 2), ("scenario", "clients"))],
    ids=["four-devices", "clients-axis"])
def test_multi_device_mesh_raises(lstm_grid, mesh):
    """The JAX package's errors, with its words, before any rank is asked:
    K=6 does not divide four client shards, and a client mesh cannot
    carry a scenario grid.  A mesh of one device sweeps on the engine's
    device, as ``mesh=None``."""
    g = lstm_grid
    n = mesh.shape[1]
    if 6 % n:
        with pytest.raises(ValueError, match=f"K=6 must divide the mesh's "
                                             f"clients axis \\({n} shards"):
            g.teng.scan_v_grid([1.0, 2.0], g.teng.fresh_carry(), g.txs,
                               mesh=mesh)
    with pytest.raises(ValueError, match="supports 1-D \\('scenario',\\) "
                                         "meshes only"):
        g.teng.scan_scenario_grid({"V": np.ones(2)}, g.teng.fresh_carry(),
                                  g.txs, mesh=mesh)
    xs = tree_map(lambda x: x[:1], g.txs)
    one = g.teng.scan_v_grid([1.0, 2.0], g.teng.fresh_carry(), xs,
                             mesh=FakeMesh((1,), ("scenario",)))
    ref = g.teng.scan_v_grid([1.0, 2.0], g.teng.fresh_carry(), xs,
                             mesh=None)
    for x, y in zip(tree_leaves(one[0]) + tree_leaves(one[1]),
                    tree_leaves(ref[0]) + tree_leaves(ref[1])):
        assert _same(x, y)


def test_transformer_grid_matches_jax():
    """A 2-row grid on the transformer encoder, 2 rounds, against the JAX
    package's sweep."""
    tgrid, jgrid = _grids("transformer", GRID_ROWS[1:])
    jeng, teng, jxs, txs = _engines(tgrid, jgrid, "transformer", rounds=2)
    t = teng.scan_scenario_grid(
        tgrid.overrides, teng.fresh_carry(), txs, stores=tgrid.stores,
        test_sets=(tgrid.test_features, tgrid.test_labels))
    j = jeng.scan_scenario_grid(
        jgrid.overrides, jeng.fresh_carry(), jxs, stores=jgrid.stores,
        test_sets=(jgrid.test_features, jgrid.test_labels), mesh=None)
    _assert_grid_match(t, j)


def test_v_grid_sweep_emits_curves_without_host_eval(monkeypatch):
    """``scan_v_grid``'s aux carries per-(V, round) metrics gated by
    ``eval_mask`` ([n_V, R], NaN off the cadence), with no
    ``adapter.evaluate`` call (tests/test_eval_fused.py)."""
    exp = MFLExperiment("iemocap", engine="fused", scheduler="random",
                        eval_every=2, n_samples=200, seed=3, device="cpu")
    eng = exp._get_fused_engine()
    xs = draw_round_xs(exp, 4, include_final=True)
    calls = []
    monkeypatch.setattr(exp.adapter, "evaluate",
                        lambda *a, **k: calls.append(1))
    carries, auxs = eng.scan_v_grid([0.1, 1.0], exp._carry, xs)
    assert not calls
    mask = _np(auxs.eval_mask)
    assert mask.shape == (2, 4)
    np.testing.assert_array_equal(mask[0], [True, False, True, True])
    mm = _np(auxs.metrics["multimodal"])
    assert np.isfinite(mm[mask]).all()
    assert np.isnan(mm[~mask]).all()
    assert carries.Q.shape == (2, exp.params.K)


def test_draw_population_xs_include_final():
    pol = JCSBAPolicy(6, SolverHyper(**HP))
    rng = np.random.default_rng(0)
    xs = draw_population_xs(Channel(PARAMS, rng), rng, 6, 5, eval_every=0,
                            include_final=True, policy=pol, device="cpu")
    np.testing.assert_array_equal(xs.eval_flag.numpy(),
                                  [False] * 4 + [True])
