"""The fused round's building blocks in the port against the JAX package's,
on the same numpy arrays: the population store and its cohort gather, the
traced Eq. 12 forms and the cohort scatter (empty and full cohorts
included), the ζ/δ trackers, the eval fillers and the stacked eval, and the
property tests of ``tests/test_fused_properties.py`` on the port's
functions.  Masks and scatters agree exactly; the Eq. 12 weights to 1e-6
relative (a float32 sum in another grouping), contractions and norms to
float32 reduction order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_cpu import one_torch_thread  # noqa: F401
from repro.core import aggregation as jagg
from repro.core import convergence as jconv
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.fl import eval as jeval
from repro.models import paper_models as jpm
from repro.wireless.policies import cohort_indices as j_cohort_indices
from repro_torch.convert import params_from_numpy
from repro_torch.core import aggregation as agg
from repro_torch.core import convergence as conv
from repro_torch.core.trees import tree_leaves, tree_map
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import eval as teval
from repro_torch.fl.fused_round import (FusedCarry, RoundAux, RoundXs,
                                        tree_row)
from repro_torch.wireless.cost import ClientCost
from repro_torch.wireless.lyapunov import queue_update
from repro_torch.wireless.params import WirelessParams
from repro_torch.wireless.policies import DropoutPolicy, cohort_indices

T = torch.as_tensor


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _random_case(rng, K=12, J=5, n_mods=2, leaf_shapes=((3,), (2, 4))):
    """A random round as numpy: schedule, cohort indices, sizes, ownership,
    upload masks, zeroed-out gradient stacks and globals."""
    mods = [f"m{i}" for i in range(n_mods)]
    a = np.zeros(K, bool)
    a[rng.choice(K, size=rng.integers(0, J + 1), replace=False)] = True
    idx = np.array(j_cohort_indices(jnp.asarray(a), J))
    D = rng.uniform(1.0, 9.0, K).astype(np.float32)
    has = {m: rng.random(K) < 0.8 for m in mods}
    upload = {m: a & has[m] & (rng.random(K) < 0.9) for m in mods}
    g = {m: {f"w{j}": (rng.standard_normal((K,) + s).astype(np.float32)
                       * upload[m].reshape((K,) + (1,) * len(s)))
             for j, s in enumerate(leaf_shapes)} for m in mods}
    glob = {m: {f"w{j}": rng.standard_normal(s).astype(np.float32)
                for j, s in enumerate(leaf_shapes)} for m in mods}
    return mods, a, idx, D, has, upload, g, glob


def _t_tree(tree):
    return params_from_numpy(tree, "cpu")


def _close(t_tree, j_tree, atol=1e-6):
    tl = [x.numpy() for x in tree_leaves(t_tree)]
    jl = jax.tree.leaves(_np_tree(j_tree))
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=atol)


# ---------------------------------------------------------------------------
# the population store
# ---------------------------------------------------------------------------
def test_client_store_and_take_match_jax():
    ds = jsyn.DATASETS["crema_d"](seed=2, n=90)
    cl_j = jpart.partition(ds, 5, 0.4, seed=2)
    cl_t = tpart.partition(tsyn.DATASETS["crema_d"](seed=2, n=90), 5, 0.4,
                           seed=2)
    mods = sorted(ds.features)
    cost = [np.linspace(1, 2, 5), np.linspace(0, 1, 5), np.linspace(3, 4, 5)]
    sj = jpart.build_client_store(jpart.stack_clients(cl_j, mods), *cost)
    st_np = tpart.build_client_store(tpart.stack_clients(cl_t, mods), *cost)
    assert st_np.K == sj.K == 5 and st_np.modalities == sj.modalities
    st_t = st_np.to("cpu")
    assert isinstance(st_t.labels, torch.Tensor)
    idx = np.array([3, 0, 4], np.int32)
    tj = sj.take(jnp.asarray(idx))
    tt = st_t.take(T(idx))
    for f in ("labels", "sample_mask", "sizes", "gamma_bits", "tau_cmp",
              "e_cmp"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)))
    for m in mods:
        np.testing.assert_array_equal(tt.features[m].numpy(),
                                      np.asarray(tj.features[m]))
        np.testing.assert_array_equal(tt.has_modality[m].numpy(),
                                      np.asarray(tj.has_modality[m]))


def test_synthetic_population_matches_jax():
    shapes = {"audio": (4, 3), "image": (2, 2, 3)}
    sj = jpart.synthetic_population(40, 6, shapes, 5, {"audio": 0.3,
                                                       "image": 0.5},
                                    seed=3, snr=[1.0, 2.0])
    st_ = tpart.synthetic_population(40, 6, shapes, 5, {"audio": 0.3,
                                                        "image": 0.5},
                                     seed=3, snr=[1.0, 2.0])
    np.testing.assert_array_equal(st_.labels, np.asarray(sj.labels))
    np.testing.assert_array_equal(st_.sizes, np.asarray(sj.sizes))
    for m in shapes:
        np.testing.assert_array_equal(st_.features[m],
                                      np.asarray(sj.features[m]))
        np.testing.assert_array_equal(st_.has_modality[m],
                                      np.asarray(sj.has_modality[m]))
    # every client keeps a modality, every modality an owner
    own = np.stack([st_.has_modality[m] for m in sorted(shapes)])
    assert own.any(0).all() and own.any(1).all()


# ---------------------------------------------------------------------------
# the traced Eq. 12 forms and the cohort scatter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_traced_aggregation_matches_jax(seed):
    rng = np.random.default_rng(seed)
    K, J = 12, 5
    mods, a, idx, D, has, upload, g, glob = _random_case(rng, K, J)
    drop = {mods[0]: rng.random(K) < 0.3}
    uj = jagg.upload_masks_traced(jnp.asarray(a), has, drop)
    ut = agg.upload_masks_traced(T(a), {m: T(v) for m, v in has.items()},
                                 {m: T(v) for m, v in drop.items()})
    for m in mods:
        np.testing.assert_array_equal(ut[m].numpy(), np.asarray(uj[m]))
    wj = jagg.stacked_weights_traced(D, upload)
    wt = agg.stacked_weights_traced(T(D), {m: T(v) for m, v in
                                           upload.items()})
    for m in mods:
        np.testing.assert_allclose(wt[m].numpy(), np.asarray(wj[m]),
                                   rtol=1e-6, atol=0)
    _close(agg.aggregate_stacked_traced(_t_tree(glob), _t_tree(g), wt),
           jagg.aggregate_stacked_traced(glob, g, wj))
    _close(agg.aggregate_gradients_stacked_traced(_t_tree(g), wt),
           jagg.aggregate_gradients_stacked_traced(g, wj))
    # the cohort view: gathered rows, scattered weights
    wcj = jagg.stacked_weights_traced(jnp.asarray(D)[idx],
                                      {m: jnp.asarray(upload[m])[idx]
                                       for m in mods})
    wct = agg.stacked_weights_traced(T(D)[T(idx).long()],
                                     {m: T(upload[m])[T(idx).long()]
                                      for m in mods})
    dj = jagg.cohort_weights_dense(wcj, jnp.asarray(idx), K)
    dt = agg.cohort_weights_dense(wct, T(idx), K)
    for m in mods:
        np.testing.assert_allclose(dt[m].numpy(), np.asarray(dj[m]),
                                   rtol=1e-6, atol=0)
        # the cohort's weight sum runs over J terms, the dense one over K
        # with zeros between (another grouping in torch's vectorised sum)
        np.testing.assert_allclose(dt[m].numpy(), wt[m].numpy(), rtol=1e-6,
                                   atol=0)


def test_cohort_aggregation_empty_and_full_cohort():
    rng = np.random.default_rng(99)
    K = J = 8
    mods, a, idx, D, has, upload, g, glob = _random_case(rng, K, J)
    # empty schedule: zero weights, globals bit-identical
    idx0 = cohort_indices(torch.zeros(K, dtype=torch.bool), J)
    w_c = agg.stacked_weights_traced(
        T(D)[idx0.long()], {m: torch.zeros(J, dtype=torch.bool)
                            for m in mods})
    gt = _t_tree(g)
    new = agg.aggregate_stacked_traced(
        _t_tree(glob), {m: {k: v[idx0.long()] for k, v in gt[m].items()}
                        for m in mods}, w_c)
    for m in mods:
        assert float(w_c[m].abs().sum()) == 0.0
        for x, y in zip(tree_leaves(new[m]), jax.tree.leaves(glob[m])):
            np.testing.assert_array_equal(x.numpy(), y)
    # the whole population: the gather is the identity
    idx1 = cohort_indices(torch.ones(K, dtype=torch.bool), K)
    np.testing.assert_array_equal(idx1.numpy(), np.arange(K))
    full = {m: T(has[m]) for m in mods}
    dense = agg.stacked_weights_traced(T(D), full)
    back = agg.cohort_weights_dense(
        agg.stacked_weights_traced(T(D)[idx1.long()],
                                   {m: v[idx1.long()] for m, v in
                                    full.items()}), idx1, K)
    for m in mods:
        np.testing.assert_array_equal(back[m].numpy(), dense[m].numpy())


@pytest.mark.parametrize("K,J", [(10, 4), (6, 6), (5, 1)])
def test_scatter_cohort_rows_is_the_inverse_of_take(K, J):
    rng = np.random.default_rng(K * 10 + J)
    idx = rng.choice(K, J, replace=False).astype(np.int32)
    vals = rng.standard_normal((J, 3)).astype(np.float32)
    dense = agg.scatter_cohort_rows(T(vals), T(idx), K).numpy()
    np.testing.assert_array_equal(
        dense, np.asarray(jagg.scatter_cohort_rows(jnp.asarray(vals),
                                                   jnp.asarray(idx), K)))
    np.testing.assert_array_equal(dense[idx], vals)
    np.testing.assert_array_equal(dense[np.setdiff1d(np.arange(K), idx)],
                                  0.0)


def test_cohort_indices_match_jax():
    rng = np.random.default_rng(7)
    for _ in range(40):
        K = int(rng.integers(1, 30))
        J = int(rng.integers(1, K + 1))
        a = rng.random(K) < rng.random()
        np.testing.assert_array_equal(
            cohort_indices(T(a), J).numpy(),
            np.asarray(j_cohort_indices(jnp.asarray(a), J)))


# ---------------------------------------------------------------------------
# the ζ/δ trackers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_trackers_match_jax(seed):
    rng = np.random.default_rng(seed + 40)
    K, J = 12, 5
    mods, a, idx, D, has, upload, g, glob = _random_case(rng, K, J)
    m = mods[0]
    z0 = np.float32(rng.uniform(0.5, 2.0))
    d0 = rng.uniform(0.1, 1.0, K).astype(np.float32)
    wj = jagg.stacked_weights_traced(D, upload)
    agj = jagg.aggregate_gradients_stacked_traced(g, wj)[m]
    wt = agg.stacked_weights_traced(T(D), {k: T(v) for k, v in
                                           upload.items()})
    agt = agg.aggregate_gradients_stacked_traced(_t_tree(g), wt)[m]
    gt = _t_tree(g)[m]
    gc = {k: v[T(idx).long()] for k, v in gt.items()}
    gcj = {k: np.asarray(v)[idx] for k, v in g[m].items()}
    uc = upload[m][idx]

    zj, nj = jconv.tracker_partials_diff(g[m], agj)
    zt, nt = conv.tracker_partials_diff(gt, agt)
    np.testing.assert_allclose(float(zt), float(zj), rtol=1e-6)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-5,
                               atol=1e-6)
    Gj = jconv.grad_gram(gcj)
    Gt = conv.grad_gram(gc)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), rtol=1e-5,
                               atol=1e-6)
    wcj = np.asarray(wj[m])[idx]
    zj2, nj2 = jconv.tracker_partials_gram(Gj, wcj)
    zt2, nt2 = conv.tracker_partials_gram(Gt, T(wcj))
    np.testing.assert_allclose(float(zt2), float(zj2), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nt2.numpy(), np.asarray(nj2), rtol=1e-4,
                               atol=1e-5)

    cases = [
        (jconv.tracker_update_masked(z0, d0, g[m], agj, upload[m], has[m],
                                     0.9),
         conv.tracker_update_masked(T(z0), T(d0), gt, agt, T(upload[m]),
                                    T(has[m]), 0.9)),
        (jconv.tracker_update_cohort(z0, d0, gcj, agj, uc, jnp.asarray(idx),
                                     has[m], 0.9),
         conv.tracker_update_cohort(T(z0), T(d0), gc, agt, T(uc), T(idx),
                                    T(has[m]), 0.9)),
        (jconv.tracker_update_gram(z0, d0, Gj, wcj, uc, jnp.asarray(idx),
                                   has[m], 0.9),
         conv.tracker_update_gram(T(z0), T(d0), Gt, T(wcj), T(uc), T(idx),
                                  T(has[m]), 0.9)),
    ]
    for (zj_, dj_), (zt_, dt_) in cases:
        np.testing.assert_allclose(float(zt_), float(zj_), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(dt_.numpy(), np.asarray(dj_), rtol=1e-4,
                                   atol=1e-5)


def test_tracker_keeps_state_when_nothing_uploaded():
    K = 6
    z0, d0 = T(np.float32(1.5)), T(np.linspace(0.1, 0.6, K, dtype=np.float32))
    gram = torch.zeros(K, K)
    z, d = conv.tracker_update_gram(z0, d0, gram, torch.zeros(K),
                                    torch.zeros(K, dtype=torch.bool),
                                    torch.arange(K),
                                    torch.ones(K, dtype=torch.bool), 0.9)
    assert float(z) == 1.5
    np.testing.assert_array_equal(d.numpy(), d0.numpy())


# ---------------------------------------------------------------------------
# the eval fillers and the stacked eval
# ---------------------------------------------------------------------------
def test_nan_metrics_and_device_test_set_match_jax():
    mods = ("audio", "image")
    nj = jeval.nan_metrics(mods)
    nt = teval.nan_metrics(mods, "cpu")
    assert list(nt) == list(nj) == list(teval.metric_keys(mods))
    assert all(v.dtype == torch.float32 and torch.isnan(v)
               for v in nt.values())
    ds = tsyn.DATASETS["crema_d"](seed=1, n=20)
    feats, labels = teval.device_test_set(ds, "cpu")
    assert sorted(feats) == sorted(ds.features)
    np.testing.assert_array_equal(labels.numpy(), ds.labels)


def test_eval_metrics_stacked_matches_jax():
    ds = jsyn.DATASETS["crema_d"](seed=4, n=24)
    feats = {m: jnp.asarray(x) for m, x in sorted(ds.features.items())}
    labels = jnp.asarray(ds.labels)
    rows = [jpm.init_crema_model(jax.random.key(s)) for s in (0, 1)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *rows)
    mj = jeval.eval_metrics_stacked(stacked, feats, labels)
    mt = teval.eval_metrics_stacked(
        params_from_numpy(_np_tree(stacked), "cpu"),
        {m: T(np.array(x)) for m, x in feats.items()},
        T(np.array(labels)))
    assert sorted(mt) == sorted(mj)
    for k in mj:
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# properties (tests/test_fused_properties.py, on the port's functions)
# ---------------------------------------------------------------------------
@settings(max_examples=15, deadline=None)
@given(st.integers(1, 32), st.integers(0, 2 ** 31 - 1),
       st.floats(0.0, 0.1))
def test_queue_update_nonnegative_recursion(K, seed, E_add):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(0, 1.0, K)
    for _ in range(5):
        used = rng.uniform(0, 0.5, K) * rng.integers(0, 2, K)
        Qn = np.asarray(queue_update(Q, used, E_add))
        assert (Qn >= 0).all()
        np.testing.assert_allclose(Qn, np.maximum(Q - (E_add - used), 0))
        # the fused round's float32 tensor recursion agrees
        Qt = queue_update(T(Q, dtype=torch.float32),
                          T(used, dtype=torch.float32), E_add)
        np.testing.assert_allclose(Qt.numpy(), Qn, rtol=1e-5, atol=1e-6)
        Q = Qn


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 16), st.integers(0, 2 ** 31 - 1),
       st.floats(1e-4, 0.05), st.floats(0.0, 0.05))
def test_tau_residual_monotone_in_tau_max(K, seed, tau_lo, tau_gap):
    rng = np.random.default_rng(seed)
    cost = ClientCost(gamma_bits=rng.uniform(1e5, 1e6, K),
                      tau_cmp=rng.uniform(0, 0.02, K),
                      e_cmp=rng.uniform(0, 0.01, K))
    lo = cost.tau_residual(WirelessParams(tau_max=tau_lo))
    hi = cost.tau_residual(WirelessParams(tau_max=tau_lo + tau_gap))
    assert (hi >= lo).all()
    np.testing.assert_allclose(hi - lo, tau_gap, atol=1e-12)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 8), st.integers(1, 3), st.integers(0, 2 ** 31 - 1))
def test_fused_carry_tree_roundtrip(K, M, seed):
    rng = np.random.default_rng(seed)
    mods = [f"m{i}" for i in range(M)]
    f32 = lambda x: T(np.asarray(x, np.float32))            # noqa: E731
    carry = FusedCarry(
        params={m: {"w": f32(rng.normal(size=(4, 2))),
                    "b": f32(rng.normal(size=(2,)))} for m in mods},
        policy={"warm_a": T(rng.integers(0, 2, K).astype(bool))},
        Q=f32(rng.uniform(0, 1, K)), spent=f32(rng.uniform(0, 1, K)),
        zeta=f32(rng.uniform(0, 2, M)), delta=f32(rng.uniform(0, 1, (M, K))),
        model_dist=f32(rng.uniform(0, 1, K)))
    leaves = tree_leaves(carry)
    assert len(leaves) == 2 * M + 6
    # the JAX package's leaf order on the same tree
    want = jax.tree.leaves(tree_map(lambda x: x.numpy(), carry))
    assert len(want) == len(leaves)
    for a, b in zip(leaves, want):
        np.testing.assert_array_equal(a.numpy(), b)
    rebuilt = tree_map(lambda x: x.clone(), carry)
    assert isinstance(rebuilt, FusedCarry)
    for a, b in zip(leaves, tree_leaves(rebuilt)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_round_trees_slice_along_rounds():
    """RoundXs rows slice along the leading round axis; RoundAux leaves
    stack along it."""
    K, R = 4, 3
    xs = RoundXs(h=torch.zeros(R, K), draw_seed=torch.zeros(R,
                                                            dtype=torch.long),
                 client_seeds=torch.zeros(R, K, dtype=torch.long),
                 eval_flag=torch.zeros(R, dtype=torch.bool),
                 draws={"u": torch.zeros(R, K)})
    x0 = tree_row(xs, 0)
    assert isinstance(x0, RoundXs) and x0.h.shape == (K,)
    assert x0.eval_flag.shape == () and x0.draws["u"].shape == (K,)
    aux = RoundAux(a=torch.zeros(K, dtype=torch.bool),
                   ok=torch.zeros(K, dtype=torch.bool), J=torch.zeros(()),
                   weights={"m": torch.zeros(K)}, energy_total=torch.zeros(()),
                   drop={"m": torch.zeros(K, dtype=torch.bool)},
                   metrics={"multimodal": torch.full((), float("nan"))},
                   eval_mask=torch.zeros((), dtype=torch.bool))
    stacked = tree_map(lambda x: torch.stack([x, x]), aux)
    assert isinstance(stacked, RoundAux)
    assert stacked.weights["m"].shape == (2, K)
    assert stacked.metrics["multimodal"].shape == (2,)


def _drop_round(K, seed, p_drop):
    rng = np.random.default_rng(seed)
    names = [f"m{i}" for i in range(3)]
    mods = [tuple(rng.choice(names, size=int(rng.integers(1, 4)),
                             replace=False)) for _ in range(K)]
    pol = DropoutPolicy.from_modalities(K, mods, max(K // 2, 1), p_drop)
    gen = torch.Generator().manual_seed(seed)
    _, a, _B, _J, drop, _idx = pol.step_full(
        {}, {"B_max": 10e6}, torch.zeros(K), pol.draws(gen, "cpu"))
    return pol, a.numpy(), drop.numpy()


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 16), st.integers(0, 2 ** 31 - 1), st.floats(0.0, 1.0))
def test_dropped_modality_never_weighted(K, seed, p_drop):
    """A dropped modality is out of the Eq. 12 upload masks, so its weight
    is exactly zero, whatever the participation set."""
    pol, a, drop = _drop_round(K, seed, p_drop)
    owns = np.asarray(pol.owns)
    has = {m: T(owns[i]) for i, m in enumerate(pol.drop_mods)}
    drop_d = {m: T(drop[i]) for i, m in enumerate(pol.drop_mods)}
    upload = agg.upload_masks_traced(T(a), has, drop_d)
    D = np.random.default_rng(seed).integers(1, 100, K).astype(np.float32)
    w = agg.stacked_weights_traced(T(D), upload)
    for i, m in enumerate(pol.drop_mods):
        w_m = w[m].numpy()
        assert (w_m[drop[i]] == 0).all()
        assert (w_m[~owns[i]] == 0).all()
        tot = w_m.sum()
        assert tot == 0 or abs(tot - 1.0) < 1e-5
