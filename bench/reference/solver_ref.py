# Frozen copy of src/repro/wireless/solver/ref.py (numpy only), kept verbatim so the
# reference derives the same inputs from the seed without importing the
# program.  Edited only where it imported its package, and in
# ``solve_round_np``: the draws are passed in (``solve_round_np(data, seeds,
# draws, hp)``) instead of being made with ``jax.random`` inside, and
# ``round_J`` (``judge.py``) may round every J it ranks.
"""Float64 numpy reference for the batched JCSBA solver.

Mirrors ``jaxsolver`` operation-for-operation — same fixed-iteration
bisections, same brackets, same series-stabilised φ, same stable sorts, and
the *same random bits* (it consumes ``jaxsolver.make_draws`` eagerly).  The
two backends therefore walk identical immune-search trajectories up to
float32 rounding, which is what ``tests/test_solver_parity.py`` pins down.

This is the ``solver="np"`` backend of ``schedulers.JCSBAScheduler`` and the
readable specification of the batched algorithm; the original scalar
implementations (``bandwidth.allocate``, ``immune.immune_search``) remain the
mathematical reference for the *sequential* path (``solver="seq"``).
"""
from __future__ import annotations

import numpy as np

from .solver_common import (B_CAP, B_LO, BMIN_SAFETY, KAPPA_TINY, PHI_SERIES_X,
                     TOL_B, SolverHyper)

LN2 = float(np.log(2.0))


# ---------------------------------------------------------------------------
# physics — numpy twins of jaxsolver._rate / _phi / _bmin / _phi_inv
# ---------------------------------------------------------------------------
def _rate(B, h, p_tx, N0):
    x = p_tx * h / (B * N0)
    return B * np.log1p(x) / LN2


def _phi(B, Q, gamma, h, p_tx, N0):
    x = p_tx * h / (B * N0)
    ln1x = np.log1p(x)
    exact = x / (1.0 + x) - ln1x
    series = x * x * (-0.5 + x * (2.0 / 3.0 - 0.75 * x))
    num = np.where(x < PHI_SERIES_X, series, exact)
    return Q * p_tx * gamma * LN2 * num / (B * B * ln1x * ln1x)


def bmin_np(gamma, h, tau_rem, B_max, p_tx, N0, hp: SolverHyper):
    """(bmin [K], ok [K]) — vectorized Eq. 41 solve, fixed bracket/iters."""
    gamma = np.asarray(gamma, np.float64)
    h = np.asarray(h, np.float64)
    tau_rem = np.asarray(tau_rem, np.float64)
    target = gamma / np.where(tau_rem > 0, tau_rem, 1.0)
    ceiling = p_tx * h / (N0 * LN2)
    ok = (tau_rem > 0) & (target < ceiling * (1 - 1e-12))
    lo = np.full_like(h, B_LO)
    hi = np.full_like(h, 2 * B_max)
    for _ in range(hp.n_bisect_b):
        mid = 0.5 * (lo + hi)
        under = _rate(mid, h, p_tx, N0) < target
        lo = np.where(under, mid, lo)
        hi = np.where(under, hi, mid)
    return np.where(ok, hi * (1 + BMIN_SAFETY), B_CAP), ok


def _phi_inv(kappa, bmin, phi_b, Q, gamma, h, B_max, p_tx, N0,
             hp: SolverHyper):
    pinned = phi_b >= kappa                               # [P, K]
    lo = np.broadcast_to(bmin, pinned.shape).copy()
    hi = np.full(pinned.shape, B_max)
    for _ in range(hp.n_bisect_b):
        mid = 0.5 * (lo + hi)
        under = _phi(mid, Q, gamma, h, p_tx, N0) < kappa
        lo = np.where(under, mid, lo)
        hi = np.where(under, hi, mid)
    return np.where(pinned, bmin, 0.5 * (lo + hi))


def allocate_np(A, bmin, ok, Q, gamma, h, B_max, p_tx, N0,
                hp: SolverHyper):
    """Population P4.2' solve: (B [P, K], feasible [P]).  Numpy float64."""
    A = np.asarray(A, bool)
    Af = A.astype(np.float64)
    U = Af.sum(-1)
    total_min = (Af * bmin).sum(-1)
    feasible = (~(A & ~ok).any(-1)) & (total_min <= B_max + TOL_B)
    at_eq = total_min >= B_max - TOL_B
    phi_b = _phi(bmin, Q, gamma, h, p_tx, N0)
    active = A & (Q > 0)

    k_lo = np.min(np.where(active, phi_b, 0.0), axis=-1)
    k_lo = np.minimum(k_lo, -1e-35)
    u_a = np.log(-k_lo)
    u_b = np.full_like(u_a, np.log(KAPPA_TINY))
    for _ in range(hp.n_bisect_k):
        u_mid = 0.5 * (u_a + u_b)
        kap = -np.exp(u_mid)[:, None]
        t = (Af * _phi_inv(kap, bmin, phi_b, Q, gamma, h, B_max, p_tx, N0,
                           hp)).sum(-1)
        under = t < B_max
        u_a = np.where(under, u_mid, u_a)
        u_b = np.where(under, u_b, u_mid)
    B = _phi_inv(-np.exp(u_b)[:, None], bmin, phi_b, Q, gamma, h,
                 B_max, p_tx, N0, hp)
    B = np.where(A, B, 0.0)

    slack = B_max - B.sum(-1)
    freem = A & (B > bmin + TOL_B)
    nfree = freem.sum(-1)
    add = np.where((nfree > 0)[:, None],
                   freem * (slack / np.maximum(nfree, 1))[:, None],
                   Af * (slack / np.maximum(U, 1))[:, None])
    B_kkt = np.where(A, np.maximum(B + add, bmin), 0.0)

    B_eq = np.where(A, bmin, 0.0)
    B_q0 = np.where(
        A, bmin + ((B_max - total_min) / np.maximum(U, 1))[:, None], 0.0)
    B = np.where(at_eq[:, None], B_eq,
                 np.where(active.any(-1)[:, None], B_kkt, B_q0))
    return np.where(feasible[:, None], B, 0.0), feasible


# ---------------------------------------------------------------------------
# Theorem-1 objective — float64 mirror of convergence.objective_batched
# ---------------------------------------------------------------------------
def bound_objective_np(A, zeta2, delta2, wbar, has, D, eta, rho,
                       gamma: float = 1.0):
    Af = np.asarray(A, np.float64)
    part = has[None] & (Af[:, None, :] > 0.5)             # [P, M, K]
    sched = part.any(-1)
    A1 = ((~sched) * zeta2).sum(-1)
    wt_raw = np.where(part, D, 0.0)
    denom = wt_raw.sum(-1, keepdims=True)
    wt = np.where(denom > 0, wt_raw / np.maximum(denom, 1e-30), 0.0)
    cover = (Af[:, None, :] * wbar).sum(-1)
    coeff = wt + wbar - 2.0 * Af[:, None, :] * wbar
    A2_m = 2.0 * (1.0 - cover) * (coeff * delta2).sum(-1)
    A2 = np.maximum((sched * A2_m).sum(-1), 0.0)
    covered = (sched * zeta2).sum(-1)
    c = (2 * eta - gamma * eta ** 2) / 2.0
    return eta * rho * np.sqrt(A1 + A2) - c * covered


def objective_np(A, B, feasible, data: dict):
    """J₂(a) for the population; infeasible rows → +inf."""
    A = np.asarray(A, bool)
    Af = A.astype(np.float64)
    r = _rate(np.maximum(B, B_LO), data["h"], data["p_tx"], data["N0"])
    tcom = np.where(A, data["gamma"] / np.maximum(r, 1e-30), 0.0)
    energy = (Af * data["Q"] * (data["p_tx"] * tcom
                                + data["e_cmp"])).sum(-1)
    bound = bound_objective_np(Af, data["zeta2"], data["delta2"],
                               data["wbar"], data["has"], data["D"],
                               data["eta"], data["rho"])
    return np.where(feasible, data["V"] * bound + energy, np.inf)


def _affinity(vals, hp: SolverHyper):
    finite = np.isfinite(vals)
    if not finite.any():
        return np.zeros_like(vals)
    jmax = np.max(np.where(finite, vals, -np.inf))
    jmin = np.min(np.where(finite, vals, np.inf))
    span = max(jmax - jmin, 1e-12)
    base = np.maximum((jmax - vals) / span, 0.0) + 1e-6
    return np.where(finite, base ** hp.iota, 0.0)


# ---------------------------------------------------------------------------
# immune search (Algorithm 2), batched — mirrors jaxsolver.solve_core
# ---------------------------------------------------------------------------
def solve_round_np(data: dict, seeds: np.ndarray, draws,
                   hp: SolverHyper, round_J=None):
    """One JCSBA solve on the numpy backend: (a* [K] bool, J*, B* [K]).
    ``round_J``, if given, maps each batch of J values before the search
    ranks them."""
    K = len(data["Q"])
    bmin, ok = bmin_np(data["gamma"], data["h"], data["tau_rem"],
                       data["B_max"], data["p_tx"], data["N0"], hp)

    def J_batch(A):
        B, feas = allocate_np(A, bmin, ok, data["Q"], data["gamma"],
                              data["h"], data["B_max"], data["p_tx"],
                              data["N0"], hp)
        J = objective_np(A, B, feas, data)
        return J if round_J is None else round_J(J)

    init, mut, fresh = (np.asarray(d, bool) for d in draws)
    pop = init.copy()
    pop[0], pop[1] = np.asarray(seeds[0], bool), np.asarray(seeds[1], bool)

    best_a, best_J = np.zeros(K, bool), np.inf

    def fold_best(pop, vals, best_a, best_J):
        i = int(np.argmin(vals))
        if vals[i] < best_J:
            return pop[i].copy(), vals[i]
        return best_a, best_J

    # mirror of the jax path's carried values: J is row-wise, so kept rows
    # re-use the candidate values computed when they were selected
    vals = J_batch(pop)
    for g in range(hp.G):
        best_a, best_J = fold_best(pop, vals, best_a, best_J)
        aff = _affinity(vals, hp)
        ham = (pop[:, None, :] ^ pop[None, :, :]).sum(-1)
        con = (ham <= hp.dis).astype(np.float64).mean(-1)     # Eq. 51-52
        inc = hp.eps1 * aff - hp.eps2 * con                   # Eq. 53
        elites = pop[np.argsort(-inc, kind="stable")[:hp.n_elite]]
        clones = np.repeat(elites, hp.mu, axis=0)             # μ-fold cloning
        mutants = clones ^ mut[g]
        cand = np.concatenate([mutants, elites], axis=0)
        cand_vals = J_batch(cand)
        cand_aff = _affinity(cand_vals, hp)
        order = np.argsort(-cand_aff, kind="stable")[:hp.n_keep]
        pop = np.concatenate([cand[order], fresh[g]], axis=0)
        vals = np.concatenate([cand_vals[order], J_batch(fresh[g])])

    best_a, best_J = fold_best(pop, vals, best_a, best_J)     # final gen
    B, _ = allocate_np(best_a[None], bmin, ok, data["Q"], data["gamma"],
                       data["h"], data["B_max"], data["p_tx"],
                       data["N0"], hp)
    return best_a, float(best_J), B[0]
