"""The port's scheduling policies (``repro_torch.wireless.policies``) and
their schedulers against the JAX package's, on the CPU.

Each policy's ``step_full`` gets the JAX package's own ``jax.random`` bits
for the round's seed (``_torch_jax_parity.jax_draw_source``, built as
``repro/wireless/policies.py`` draws them), so state, schedule, bandwidth,
J, drop mask and cohort vector must equal ``policy_step``'s: exactly for
the baselines (the same float32 operations), at the solver's tolerances
for JCSBA (B rtol 1e-3 / atol 2 Hz, J rel 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_parity import jax_draw_source, setup as _setup
from _torch_jax_parity import solver_data as _data
from repro.wireless import policies as jpol
from repro.wireless.solver import jaxsolver as sjax
from repro_torch.wireless import policies as tpol
from repro_torch.wireless.schedulers import (ScheduleContext, make_scheduler)
from repro_torch.wireless.solver import torchsolver

K = 8
#: three modalities, uni- and multimodal clients, so Selection has several
#: groups and Dropout several owned rows to pick from
MODS8 = [("audio", "image", "text"), ("audio",), ("image", "text"),
         ("audio", "image"), ("text",), ("audio", "image", "text"),
         ("image",), ("audio", "text")]


def _policies(K=K, mods=MODS8):
    return {
        "jcsba": (jpol.JCSBAPolicy(K, jpol.SolverHyper(S=8, G=3)),
                  tpol.JCSBAPolicy(K, tpol.SolverHyper(S=8, G=3))),
        "random": (jpol.RandomPolicy(K, 3), tpol.RandomPolicy(K, 3)),
        "round_robin": (jpol.RoundRobinPolicy(K, 3),
                        tpol.RoundRobinPolicy(K, 3)),
        "selection": (jpol.SelectionPolicy.from_modalities(K, mods, 0.4),
                      tpol.SelectionPolicy.from_modalities(K, mods, 0.4)),
        "dropout": (jpol.DropoutPolicy.from_modalities(K, mods, 3, 0.6),
                    tpol.DropoutPolicy.from_modalities(K, mods, 3, 0.6)),
    }


@pytest.mark.parametrize("name", tpol.POLICY_NAMES)
def test_policy_step_full_matches_jax(name):
    """Three rounds of each policy, the state carried, on the same round
    seeds and model distances."""
    jp, tp = _policies()[name]
    data = _data(K=K, seed=2)
    jdata = sjax.to_device(data)
    tdata = torchsolver.to_device(data, "cpu")
    js, ts = jp.init_state(), tp.init_state()
    rng = np.random.default_rng(9)
    for t in range(3):
        seed = int(rng.integers(2 ** 31))
        dist = rng.uniform(0, 1, K).astype(np.float32)
        dist[3] = dist[5]                         # a tie for the stable sort
        js, ja, jB, jJ, jdrop, jcoh = jpol.policy_step(
            jp, {k: jnp.asarray(v) for k, v in js.items()}, jdata,
            jnp.asarray(dist), np.uint32(seed))
        ts, ta, tB, tJ, tdrop, tcoh = tp.step_full(
            ts, tdata, torch.as_tensor(dist),
            {k: torch.as_tensor(v) for k, v in
             jax_draw_source(tp, seed).items()})
        assert ts.keys() == js.keys()
        for k in js:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))
        np.testing.assert_array_equal(tcoh.numpy(), np.asarray(jcoh))
        assert tcoh.dtype == torch.int32
        if name == "jcsba":
            np.testing.assert_allclose(tB.numpy(), np.asarray(jB), rtol=1e-3,
                                       atol=2.0)
            assert float(tJ) == pytest.approx(float(jJ), rel=1e-4, abs=1e-6)
        else:
            np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
            assert np.isnan(float(tJ)) and np.isnan(float(jJ))
        assert tp.step(ts, tdata, torch.as_tensor(dist), {k: torch.as_tensor(
            v) for k, v in jax_draw_source(tp, seed).items()})[1].shape == (K,)


def test_dropout_drops_exercise_every_path():
    """Over many seeds the dropout policy drops some modality of a
    multimodal client and never one of a unimodal client — equal to the
    JAX package's mask on every seed."""
    jp, tp = _policies()["dropout"]
    owns = np.array(tp.owns)
    dropped_any = False
    for seed in range(24):
        bits = jax_draw_source(tp, seed)
        a = np.zeros(K, bool)
        a[bits["perm"][:3]] = True
        k_drop = jax.random.split(jax.random.PRNGKey(np.uint32(seed)))[1]
        jm = np.asarray(jp.drop_mask(jnp.asarray(a), k_drop))
        tm = tp.drop_mask(torch.as_tensor(a), torch.as_tensor(bits["u_drop"]),
                          torch.as_tensor(bits["u_which"])).numpy()
        np.testing.assert_array_equal(tm, jm)
        assert not tm[:, owns.sum(0) == 1].any()
        assert (tm.sum(0) <= 1).all() and not tm[:, ~a].any()
        dropped_any |= bool(tm.any())
    assert dropped_any


@pytest.mark.parametrize("seed", range(4))
def test_cohort_indices_match_jax(seed):
    rng = np.random.default_rng(seed)
    for Kc in (1, 5, 16):
        a = rng.random(Kc) < 0.4
        for size in sorted({1, max(1, Kc // 2), Kc}):
            want = np.asarray(jpol.cohort_indices(jnp.asarray(a), size))
            got = tpol.cohort_indices(torch.as_tensor(a), size)
            np.testing.assert_array_equal(got.numpy(), want)


def test_equal_bandwidth_matches_jax():
    for a in (np.zeros(5, bool), np.array([1, 0, 1, 1, 0], bool)):
        want = np.asarray(jpol.equal_bandwidth_traced(jnp.asarray(a), 1e7))
        got = tpol.equal_bandwidth_traced(torch.as_tensor(a), 1e7).numpy()
        np.testing.assert_array_equal(got, want)


def test_own_draws_have_the_jax_shapes():
    """Each policy's own draws (a torch.Generator) have the shapes and
    types of the JAX package's bits; a schedule from them is well formed."""
    g = torch.Generator().manual_seed(0)
    for name, (_, tp) in _policies().items():
        own = tp.draws(g, "cpu")
        want = jax_draw_source(tp, 0)
        assert own.keys() == want.keys(), name
        for k in want:
            assert tuple(own[k].shape) == want[k].shape, (name, k)
            assert (own[k].dtype == torch.bool) == (want[k].dtype == bool)
    perm = _policies()["dropout"][1].draws(g, "cpu")["perm"]
    assert sorted(perm.tolist()) == list(range(K))


def test_make_policy_refuses_an_unknown_name():
    assert tpol.POLICY_NAMES == jpol.POLICY_NAMES
    for name in tpol.POLICY_NAMES:
        assert tpol.make_policy(name, 4, [("audio",)] * 4).name == name
    assert tpol.make_policy("roundrobin", 4).name == "round_robin"
    with pytest.raises(ValueError, match="no policy"):
        tpol.make_policy("fifo", 4)


# ---------------------------------------------------------------------------
# schedulers: state()/load_state(), rng discipline
# ---------------------------------------------------------------------------
def _ctx(K, t, rng, cc, params, bound, mods):
    return ScheduleContext(h=10 ** rng.uniform(-7, -4, K),
                           Q=rng.uniform(0, 0.02, K), cost=cc, params=params,
                           bound=bound, round_idx=t,
                           model_dist=rng.uniform(0, 1, K),
                           client_modalities=mods)


@pytest.mark.parametrize("name,kw", [
    ("round_robin", {"n_sched": 3}), ("random", {"n_sched": 2}),
    ("jcsba", {"solver": "jax", "immune_kwargs": {"S": 8, "G": 2}}),
    ("jcsba", {"solver": "np", "immune_kwargs": {"S": 8, "G": 2}}),
    ("jcsba", {"solver": "seq"}),
])
def test_state_round_trip_resumes_identically(name, kw):
    """Two rounds, ``state()`` saved; a fresh scheduler restored from it
    (with the rng restored too) decides round 3 exactly as the original."""
    K6 = 6
    cc, params, bound, mods, _ = _setup(K6, 1, pkg="torch")
    a = make_scheduler(name, np.random.default_rng(3), device="cpu", **kw)
    a.bind(K6, mods)
    data_rng = np.random.default_rng(4)
    for t in range(2):
        a.schedule(_ctx(K6, t, data_rng, cc, params, bound, mods))
    saved = {k: v.copy() for k, v in a.state().items()}
    b = make_scheduler(name, np.random.default_rng(0), device="cpu", **kw)
    b.bind(K6, mods)
    b.load_state(saved)
    b.rng.bit_generator.state = a.rng.bit_generator.state
    for k in saved:
        np.testing.assert_array_equal(b.state()[k], saved[k])
    ctx = _ctx(K6, 2, data_rng, cc, params, bound, mods)
    da, db = a.schedule(ctx), b.schedule(ctx)
    np.testing.assert_array_equal(da.a, db.a)
    np.testing.assert_array_equal(da.B, db.B)
    if name == "round_robin":
        assert int(saved["next"]) == 6 % K6 and int(a.state()["next"]) == 3
    if name == "jcsba":
        np.testing.assert_array_equal(a.state()["warm_a"], da.a)


@pytest.mark.parametrize("name,kw", [
    ("random", {}), ("round_robin", {}), ("selection", {}), ("dropout", {}),
    ("jcsba", {"solver": "jax", "immune_kwargs": {"S": 6, "G": 1}}),
    ("jcsba", {"solver": "np", "immune_kwargs": {"S": 6, "G": 1}}),
])
def test_every_policy_scheduler_draws_one_seed_a_round(name, kw):
    """Each scheduler takes exactly one ``rng.integers(2**31)`` a round, so
    the experiment's numpy stream stays in step with the JAX package's."""
    K6 = 6
    cc, params, bound, mods, _ = _setup(K6, 2, pkg="torch")
    s = make_scheduler(name, np.random.default_rng(5), device="cpu", **kw)
    ref = np.random.default_rng(5)
    data_rng = np.random.default_rng(6)
    for t in range(2):
        dec = s.schedule(_ctx(K6, t, data_rng, cc, params, bound, mods))
        ref.integers(2 ** 31)
        assert dec.a.dtype == bool and dec.B.shape == (K6,)
        assert (dec.B[~dec.a] == 0).all()
    assert s.rng.integers(2 ** 31) == ref.integers(2 ** 31)
