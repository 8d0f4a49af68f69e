"""The port's batched JCSBA solver against the JAX package's, on the CPU.

Inputs are numpy, made from a seed, and go to both packages; the solver's
random bits are the JAX package's own (``jaxsolver.make_draws``), handed to
the port as arrays.  Tolerances are those of tests/test_solver_parity.py:
feasibility equal; B within rtol 1e-3, atol 2 Hz (float32 bisections with
another summation order); J within rel 1e-4, abs 1e-6.  The port's ``np``
backend is float64 numpy doing the JAX package's operations on the same
bits, so it must be bitwise equal.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_jax_parity import jax_draw_source, setup as _setup
from _torch_jax_parity import solver_data as _data
from repro.core.convergence import objective_batched as j_objective_batched
from repro.wireless.channel import Channel as JChannel
from repro.wireless.schedulers import ScheduleContext as JContext
from repro.wireless.schedulers import make_scheduler as j_make_scheduler
from repro.wireless.solver import build_solver_data as j_build
from repro.wireless.solver import jaxsolver as sjax
from repro.wireless.solver import solve_round_np as j_solve_round_np
from repro_torch.core.convergence import objective_batched
from repro_torch.kernels.jcsba_solver import ops, ref
from repro_torch.wireless import bandwidth as tbw
from repro_torch.wireless.channel import uplink_rate
from repro_torch.wireless.params import WirelessParams
from repro_torch.wireless.schedulers import ScheduleContext, make_scheduler
from repro_torch.wireless.solver import (SolverHyper, build_solver_data,
                                         solve_round, solve_round_np,
                                         torchsolver)

HP = SolverHyper()
HP_SMALL = SolverHyper(S=8, G=3)


def _port_eval(data, A, hp=HP):
    d = torchsolver.to_device(data, "cpu")
    bm, ok = ops.bmin(d["gamma"], d["h"], d["tau_rem"], d["B_max"],
                      d["p_tx"], d["N0"], hp)
    J, B, feas = ops.population_objective(torch.as_tensor(A), bm, ok, d, hp,
                                          want_B=True)
    return (bm.numpy(), ok.numpy()), (J.numpy(), B.numpy().astype(np.float64),
                                      feas.numpy())


def _jax_eval(data, A, hp=HP):
    d = sjax.to_device(data)
    bm, ok = sjax._bmin(d["gamma"], d["h"], d["tau_rem"], d["B_max"],
                        d["p_tx"], d["N0"], hp)
    B, feas = sjax.allocate_batch(A, bm, ok, d["Q"], d["gamma"], d["h"],
                                  d["B_max"], d["p_tx"], d["N0"], hp)
    J = sjax.objective_batch(A, B, feas, d)
    return (np.asarray(bm), np.asarray(ok)), (
        np.asarray(J), np.asarray(B, np.float64), np.asarray(feas))


def _assert_J(Jt, Jj):
    assert np.array_equal(np.isinf(Jt), np.isinf(Jj))
    fin = np.isfinite(Jj)
    np.testing.assert_allclose(Jt[fin], Jj[fin], rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the kernels' plain versions against jaxsolver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_population_objective_matches_jax(seed):
    data = _data(K=6, seed=seed)
    A = np.random.default_rng(seed + 100).integers(0, 2, (12, 6)).astype(bool)
    A[0] = False                                     # the empty schedule
    (bt, okt), (Jt, Bt, ft) = _port_eval(data, A)
    (bj, okj), (Jj, Bj, fj) = _jax_eval(data, A)
    assert np.array_equal(okt, okj)
    np.testing.assert_allclose(bt, bj, rtol=1e-6)
    assert np.array_equal(ft, fj)
    np.testing.assert_allclose(Bt, Bj, rtol=1e-3, atol=2.0)
    _assert_J(Jt, Jj)


@pytest.mark.parametrize("case", ["infeasible", "at_eq", "q_zero",
                                  "pinned"])
def test_population_objective_branches_match_jax(case):
    """Rows that take each branch of allocate_batch: latency-infeasible
    clients, Σ B_min at the budget, every participant with Q = 0, and
    participants pinned at B_min (a near-zero queue keeps φ(B_min) above
    κ*).  Row 6 schedules clients 1, 2, 4, 5 (Σ B_min ≈ 0.84 B_max here);
    rows 0-5 one client each."""
    data = _data(K=6, seed=3, tau_max=1e-6 if case == "infeasible" else None)
    A = np.random.default_rng(5).integers(0, 2, (10, 6)).astype(bool)
    A[:6] = np.eye(6, dtype=bool)
    A[6] = [False, True, True, False, True, True]
    if case == "at_eq":
        bm = _port_eval(data, A[:1])[0][0]
        # B_max set to row 6's Σ B_min in float32
        data = dict(data, B_max=float(bm[A[6]].sum(dtype=np.float32)))
    if case == "q_zero":
        data = dict(data, Q=np.zeros(6))
    if case == "pinned":
        data = dict(data, Q=np.array([1e-12, 1.0, 1e-12, 1.0, 1e-12, 1.0]))
    (bm, _), (Jt, Bt, ft) = _port_eval(data, A)
    (_, _), (Jj, Bj, fj) = _jax_eval(data, A)
    assert np.array_equal(ft, fj)
    np.testing.assert_allclose(Bt, Bj, rtol=1e-3, atol=2.0)
    _assert_J(Jt, Jj)
    if case == "infeasible":
        assert not ft[:7].any() and (Bt[:7] == 0).all()
        return
    assert ft[6]
    if case == "at_eq":
        np.testing.assert_array_equal(Bt[6], np.where(A[6], bm, 0.0))
    if case == "q_zero":
        share = (data["B_max"] - bm[A[6]].sum()) / 4
        np.testing.assert_allclose(Bt[6][A[6]], bm[A[6]] + share, rtol=1e-6)
    if case == "pinned":
        assert (Bt[6][[2, 4]] == bm[[2, 4]]).all()
        assert (Bt[6][[1, 5]] > bm[[1, 5]]).all()


def test_bmin_injection_and_cpu_launches_nothing():
    """An injected ``data["bmin"]``/``["bmin_ok"]`` gives the same solve,
    and the CPU path launches no kernel."""
    data = _data(K=5, seed=4)
    draws = [np.array(x) for x in sjax.make_draws(jax.random.PRNGKey(3), 5,
                                                   HP_SMALL)]
    seeds = np.zeros((2, 5), bool)
    ops.reset_launch_counts()
    d = torchsolver.to_device(data, "cpu")
    a1, J1, B1 = torchsolver.solve_core(d, seeds, draws, HP_SMALL)
    bm, ok = ops.bmin(d["gamma"], d["h"], d["tau_rem"], d["B_max"],
                      d["p_tx"], d["N0"], HP_SMALL)
    a2, J2, B2 = torchsolver.solve_core(dict(d, bmin=bm, bmin_ok=ok), seeds,
                                        draws, HP_SMALL)
    assert torch.equal(a1, a2) and torch.equal(J1, J2) and torch.equal(B1,
                                                                       B2)
    assert ops.launch_counts() == {"jcsba_bmin_kernel": 0,
                                   "jcsba_population_kernel": 0}


def test_objective_batched_matches_jax():
    cc, params, bound, mods, rng = _setup(6, 5)
    data = j_build(JChannel(params, rng).draw(), np.zeros(6), cc, params,
                   bound, 1.0)
    A = np.random.default_rng(7).integers(0, 2, (16, 6)).astype(bool)
    want = np.asarray(j_objective_batched(
        A.astype(np.float32), data["zeta2"].astype(np.float32),
        data["delta2"].astype(np.float32), data["wbar"].astype(np.float32),
        data["has"], data["D"].astype(np.float32), data["eta"], data["rho"]))
    d = torchsolver.to_device(data, "cpu")
    got = objective_batched(torch.as_tensor(A), d["zeta2"], d["delta2"],
                            d["wbar"], d["has"], d["D"], data["eta"],
                            data["rho"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    exact = np.array([bound.objective(a.astype(float)) for a in A])
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-5)


def test_build_solver_data_and_snapshot_match_jax():
    """The port's copies (build_solver_data, BoundState.snapshot, costs)
    give the JAX package's round data bit for bit."""
    K = 7
    jc, jp, jb, _, jr = _setup(K, 8, pkg="jax")
    tc, tp, tb, _, tr = _setup(K, 8, pkg="torch")
    h, Q = 10 ** jr.uniform(-7, -4, K), jr.uniform(0, 0.02, K)
    dj = j_build(h, Q, jc, jp, jb, 2.0)
    dt = build_solver_data(h, Q, tc, tp, tb, 2.0)
    assert dj.keys() == dt.keys()
    for k in dj:
        np.testing.assert_array_equal(np.asarray(dt[k]), np.asarray(dj[k]))
    empty = build_solver_data(h, Q, tc, tp, None, 1.0)
    assert empty["zeta2"].shape == (0,) and empty["has"].shape == (0, K)


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,hp", [(0, HP_SMALL), (11, HP_SMALL),
                                     (3, HP)])
def test_np_backend_is_bitwise_the_jax_packages(seed, hp):
    data = _data(K=6, seed=seed)
    seeds = np.zeros((2, 6), bool)
    seeds[0, ::2] = True
    draws = [np.array(x) for x in
             sjax.make_draws(jax.random.PRNGKey(1234 + seed), 6, hp)]
    at, Jt, Bt = solve_round_np(data, seeds, draws, hp)
    aj, Jj, Bj = j_solve_round_np(data, seeds, 1234 + seed, hp)
    assert np.array_equal(at, aj)
    assert Jt == Jj
    np.testing.assert_array_equal(Bt, Bj)


@pytest.mark.parametrize("seed,hp", [(0, HP_SMALL), (11, HP_SMALL),
                                     (5, HP)])
def test_solve_core_matches_jaxsolver(seed, hp):
    data = _data(K=6, seed=seed)
    seeds = np.zeros((2, 6), bool)
    seeds[0, 1:4] = True
    draws = [np.array(x) for x in
             sjax.make_draws(jax.random.PRNGKey(77 + seed), 6, hp)]
    at, Jt, Bt = solve_round(data, seeds, draws, hp, device="cpu")
    aj, Jj, Bj = sjax.solve_round(data, seeds, 77 + seed, hp)
    assert np.array_equal(at, aj)
    assert Jt == pytest.approx(Jj, rel=1e-4, abs=1e-6)
    np.testing.assert_allclose(Bt, Bj, rtol=1e-3, atol=2.0)


def test_solve_core_all_infeasible_keeps_the_empty_schedule():
    data = _data(K=6, seed=9, tau_max=1e-6)
    draws = [np.array(x) for x in sjax.make_draws(jax.random.PRNGKey(7), 6,
                                                   HP_SMALL)]
    a, J, B = solve_round(data, np.zeros((2, 6), bool), draws, HP_SMALL,
                          device="cpu")
    assert not a.any() and np.isfinite(J) and (B == 0).all()


@pytest.mark.parametrize("solver", ["jax", "np"])
def test_scheduler_matches_jax_over_rounds(solver):
    """JCSBAScheduler over 3 rounds with warm starts (the rng stream and
    queue coupling included) against the JAX scheduler on the same seed:
    identical schedules; B and J at the solver tolerances (``np``:
    bitwise)."""
    K = 6
    decs = {}
    for pkg in ("jax", "torch"):
        data_rng = np.random.default_rng(0)
        cc, params, bound, mods, _ = _setup(K, 0, pkg=pkg)
        if pkg == "jax":
            sched = j_make_scheduler("jcsba", np.random.default_rng(42),
                                     solver=solver)
            Ctx = JContext
        else:
            sched = make_scheduler("jcsba", np.random.default_rng(42),
                                   solver=solver, device="cpu",
                                   draw_source=jax_draw_source)
            Ctx = ScheduleContext
        out = []
        for t in range(3):
            ctx = Ctx(h=10 ** data_rng.uniform(-7, -4, K),
                      Q=data_rng.uniform(0, 0.02, K), cost=cc, params=params,
                      bound=bound, round_idx=t, model_dist=np.zeros(K),
                      client_modalities=mods)
            out.append(sched.schedule(ctx))
        decs[pkg] = (out, sched.state(), sched.rng.integers(2 ** 31))
    (dj, sj, nj), (dt, stt, nt) = decs["jax"], decs["torch"]
    assert nt == nj                       # one seed draw a round, both
    np.testing.assert_array_equal(stt["warm_a"], sj["warm_a"])
    for a, b in zip(dt, dj):
        assert np.array_equal(a.a, b.a)
        if solver == "np":
            np.testing.assert_array_equal(a.B, b.B)
            assert a.objective == b.objective
        else:
            np.testing.assert_allclose(a.B, b.B, rtol=1e-3, atol=2.0)
            assert a.objective == pytest.approx(b.objective, rel=1e-4,
                                                abs=1e-6)


# ---------------------------------------------------------------------------
# the population kernel's block plan, and properties
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K,want", [(1, (32, 1)), (10, (32, 1)),
                                    (100, (128, 1)), (1000, (1024, 1)),
                                    (1025, (544, 2)), (5000, (640, 8)),
                                    (8192, (1024, 8))])
def test_population_kernel_plan(K, want):
    threads, cpt = ops.plan(K)
    assert (threads, cpt) == want
    assert threads % 32 == 0 and threads * cpt >= K


def test_population_kernel_plan_refuses_past_one_block():
    with pytest.raises(ValueError, match="8192"):
        ops.plan(8193)


def test_solver_args_match_the_c_side():
    """``build.SolverArgs`` is the C struct field for field, and each of the
    C side's fixed constants is the plain version's float32 value."""
    import ctypes
    import math
    import re
    from pathlib import Path
    from repro_torch.kernels.jcsba_solver import build
    from repro_torch.wireless.solver import common
    src = (Path(build.__file__).parent / "csrc"
           / "jcsba_solver.cu").read_text()
    body = re.search(r"struct SolverArgs \{(.*?)\};", src, re.S).group(1)
    fields = []
    for ctype, names in re.findall(r"(int|float) ([^;]+);",
                                   re.sub(r"//[^\n]*", "", body)):
        fields += [(n.strip(), ctype) for n in names.split(",")]
    assert fields == [(n, "int" if t is ctypes.c_int else "float")
                      for n, t in build.SolverArgs._fields_]
    consts = dict(re.findall(r"constexpr float (k\w+) = \(float\)(.+?);",
                             src))
    want = {"kBLo": common.B_LO, "kBCap": common.B_CAP,
            "kSafety": 1 + common.BMIN_SAFETY, "kTolB": common.TOL_B,
            "kSeriesX": common.PHI_SERIES_X,
            "kLogKappaTiny": math.log(common.KAPPA_TINY), "kLn2": ref.LN2,
            "kTwoThirds": 2.0 / 3.0, "kCeilFactor": 1 - 1e-12}
    assert set(consts) == set(want)
    for name, value in want.items():
        assert np.float32(eval(consts[name])) == np.float32(value), name


def test_launch_args_only_on_a_card():
    """A CPU solve builds no launch struct; one built for a round carries
    its K, M and fixed scalars, and not V, which the population kernel
    reads from the 0-d float32 tensor ``to_device`` makes of it."""
    d = torchsolver.to_device(_data(K=6, seed=1), "cpu")
    assert ops.launch_args(d, HP) is None
    args = ops.solver_args(6, d["zeta2"].shape[0], HP, d["B_max"],
                           d["p_tx"], d["N0"], d["eta"], d["rho"])
    assert (args.K, args.M, args.n_bisect_b, args.n_bisect_k) == (
        6, d["zeta2"].shape[0], HP.n_bisect_b, HP.n_bisect_k)
    assert args.bmax_hi == np.float32(d["B_max"] + 1.0)
    assert not hasattr(args, "V")
    assert d["V"].shape == () and d["V"].dtype == torch.float32


def test_card_check_inputs():
    """The inputs the card checks share: rows of 1-5 clients, the first
    empty and the last full; a round whose last client cannot meet its
    latency budget; ``plain_versions`` puts the wrappers back."""
    from repro_torch.kernels.jcsba_solver import checks
    A = checks.antibody_rows(12, 8, 3)
    assert not A[0].any() and A[-1].all()
    assert [int(r.sum()) for r in A[1:-1]] == [2, 3, 4, 5, 1, 2]
    assert not checks.antibody_rows(12, 1, 3).any()
    d = torchsolver.to_device(checks.synthetic_round(12, 0), "cpu")
    _, ok = ops.bmin(d["gamma"], d["h"], d["tau_rem"], d["B_max"],
                     d["p_tx"], d["N0"], HP)
    assert not ok[-1] and ok[:-1].any()
    wrappers = (ops.bmin, ops.population_objective)
    with checks.plain_versions():
        assert ops.population_objective is not wrappers[1]
        J, _, _ = ops.population_objective(torch.as_tensor(A), *ops.bmin(
            d["gamma"], d["h"], d["tau_rem"], d["B_max"], d["p_tx"],
            d["N0"], HP), d, HP, args=None)
    assert (ops.bmin, ops.population_objective) == wrappers
    assert J.shape == (8,) and torch.isinf(J[-1])


def _random_instance(seed, K):
    rng = np.random.default_rng(seed)
    params = WirelessParams(K=K)
    return params, {
        "Q": rng.uniform(0.0, 2.0, K),
        "gamma": rng.uniform(3e5, 1.2e6, K),
        "h": 10 ** rng.uniform(-7, -4, K),
        "tau_rem": rng.uniform(0.004, 0.0095, K),
        "e_cmp": rng.uniform(0.0, 0.01, K),
        "B_max": params.B_max, "p_tx": params.p_tx, "N0": params.N0,
        "V": 1.0, "eta": 0.0, "rho": 0.0,
        "zeta2": np.zeros(0), "delta2": np.zeros((0, K)),
        "wbar": np.zeros((0, K)), "has": np.zeros((0, K), bool),
        "D": np.zeros(K),
    }, rng.integers(0, 2, (8, K)).astype(bool)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_property_feasible_allocations_meet_constraints(seed):
    """The float32 plain version (the kernel's contract): a feasible row
    keeps Σ B ≤ B_max and meets In1 strictly, as the runtime checks it;
    an infeasible row is genuinely infeasible and carries B = 0."""
    params, data, A = _random_instance(seed, 5)
    (_, _), (J, B, feas) = _port_eval(data, A)
    for p in range(len(A)):
        a = A[p]
        if not feas[p]:
            bl = [tbw.b_min(data["gamma"][i], data["h"][i],
                            data["tau_rem"][i], params)
                  for i in np.flatnonzero(a)]
            assert any(b is None for b in bl) or sum(bl) > params.B_max
            assert (B[p] == 0).all() and np.isinf(J[p])
            continue
        assert (B[p][~a] == 0).all()
        assert B[p].sum() <= params.B_max * (1 + 1e-5)
        if a.any():
            part = np.flatnonzero(a)
            r = uplink_rate(B[p][part], data["h"][part], params)
            assert np.all(data["gamma"][part] / r
                          <= data["tau_rem"][part] + 1e-12)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_property_np_backend_allocations_meet_constraints(seed):
    """The same property on the float64 ``np`` backend's allocation."""
    from repro_torch.wireless.solver import ref as sref
    params, data, A = _random_instance(seed, 6)
    bm, ok = sref.bmin_np(data["gamma"], data["h"], data["tau_rem"],
                          data["B_max"], data["p_tx"], data["N0"], HP)
    B, feas = sref.allocate_np(A, bm, ok, data["Q"], data["gamma"],
                               data["h"], data["B_max"], data["p_tx"],
                               data["N0"], HP)
    for p in range(len(A)):
        a = A[p]
        if not feas[p] or not a.any():
            assert feas[p] or (B[p] == 0).all()
            continue
        part = np.flatnonzero(a)
        assert (B[p][~a] == 0).all()
        assert B[p].sum() <= params.B_max * (1 + 1e-6)
        r = uplink_rate(B[p][part], data["h"][part], params)
        assert np.all(data["gamma"][part] / r
                      <= data["tau_rem"][part] * (1 + 1e-3))
