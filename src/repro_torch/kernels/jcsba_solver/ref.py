"""Plain PyTorch versions of the two JCSBA solver kernels, float32, a
line-by-line port of the JAX package's ``wireless/solver/jaxsolver.py``:

* ``bmin``                 — ``_bmin`` (Eq. 41, per client);
* ``population_objective`` — ``allocate_batch`` followed by
  ``objective_batch``: the KKT bandwidth split (P4.2') and J₂(a) for every
  antibody row of a population.

The CPU path runs these; on a card ``ops.py`` launches the CUDA kernels,
which ``chip_smoke.py`` and the ``gpu`` tests hold against these on the same
inputs.  ``data`` is the dict of ``wireless.solver.torchsolver.to_device``:
float32 tensors for the per-client and snapshot arrays (``has`` bool) and
for V (0-d), Python floats (rounded to float32) for the fixed scalars.
"""
from __future__ import annotations

import math

import torch

from ...core.convergence import objective_batched
from ...wireless.solver.common import (B_CAP, B_LO, BMIN_SAFETY, KAPPA_TINY,
                                       PHI_SERIES_X, TOL_B, SolverHyper)

LN2 = math.log(2.0)


def rate(B, h, p_tx, N0):
    """Shannon/FDMA uplink rate r(B) (Eq. 13)."""
    x = p_tx * h / (B * N0)
    return B * torch.log1p(x) / LN2


def phi(B, Q, gamma, h, p_tx, N0):
    """φ = ∂J₃/∂B (Eq. 37), series-stabilised for small x."""
    x = p_tx * h / (B * N0)
    ln1x = torch.log1p(x)
    exact = x / (1.0 + x) - ln1x
    series = x * x * (-0.5 + x * (2.0 / 3.0 - 0.75 * x))
    num = torch.where(x < PHI_SERIES_X, series, exact)
    return Q * p_tx * gamma * LN2 * num / (B * B * ln1x * ln1x)


def bmin(gamma, h, tau_rem, B_max, p_tx, N0, hp: SolverHyper):
    """Per-client B with r(B) = Γ/τ_rem (Eq. 41): (bmin [K], ok [K] bool).

    A fixed-bracket bisection on [B_LO, 2·B_max]; latency-infeasible
    clients get the ``B_CAP`` sentinel, which kills any candidate holding
    them through the Σ B_min ≤ B_max check."""
    target = gamma / torch.where(tau_rem > 0, tau_rem, 1.0)
    ceiling = p_tx * h / (N0 * LN2)
    ok = (tau_rem > 0) & (target < ceiling * (1 - 1e-12))
    lo = torch.full_like(h, B_LO)
    hi = torch.full_like(h, 2 * B_max)
    for _ in range(hp.n_bisect_b):
        mid = 0.5 * (lo + hi)
        under = rate(mid, h, p_tx, N0) < target
        lo, hi = torch.where(under, mid, lo), torch.where(under, hi, mid)
    return torch.where(ok, hi * (1 + BMIN_SAFETY), B_CAP), ok


def _phi_inv(kappa, bmin_, phi_b, Q, gamma, h, B_max, p_tx, N0,
             hp: SolverHyper):
    """B ≥ B_min with φ(B) = κ for every (candidate, client); kappa [P, 1].
    Clients with φ(B_min) ≥ κ are pinned at B_min."""
    pinned = phi_b >= kappa                               # [P, K]
    lo = bmin_.expand(pinned.shape)
    hi = torch.full(pinned.shape, B_max, dtype=bmin_.dtype,
                    device=bmin_.device)
    for _ in range(hp.n_bisect_b):
        mid = 0.5 * (lo + hi)
        under = phi(mid, Q, gamma, h, p_tx, N0) < kappa
        lo, hi = torch.where(under, mid, lo), torch.where(under, hi, mid)
    return torch.where(pinned, bmin_, 0.5 * (lo + hi))


def allocate(A, bmin_, ok, data, hp: SolverHyper):
    """P4.2' for a whole population A ∈ {0,1}^{P×K}: (B [P, K], feasible
    [P]); infeasible rows carry B = 0 (``jaxsolver.allocate_batch``)."""
    Q, gamma, h = data["Q"], data["gamma"], data["h"]
    B_max, p_tx, N0 = data["B_max"], data["p_tx"], data["N0"]
    A = A.to(torch.bool)
    Af = A.to(bmin_.dtype)
    U = Af.sum(-1)                                        # [P]
    total_min = (Af * bmin_).sum(-1)
    feasible = (~(A & ~ok).any(-1)) & (total_min <= B_max + TOL_B)
    at_eq = total_min >= B_max - TOL_B                    # (42) with equality
    phi_b = phi(bmin_, Q, gamma, h, p_tx, N0)             # [K]
    active = A & (Q > 0)

    # κ* bisection in log(−κ) space: Σ B_k(κ) is monotone increasing in κ
    k_lo = torch.where(active, phi_b, 0.0).amin(-1)
    k_lo = torch.clamp_max(k_lo, -1e-35)  # keep log finite; dummy if ¬active
    u_a = torch.log(-k_lo)
    u_b = torch.full_like(u_a, math.log(KAPPA_TINY))
    for _ in range(hp.n_bisect_k):
        u_mid = 0.5 * (u_a + u_b)
        kap = -torch.exp(u_mid)[:, None]
        t = (Af * _phi_inv(kap, bmin_, phi_b, Q, gamma, h, B_max, p_tx, N0,
                           hp)).sum(-1)
        under = t < B_max
        u_a, u_b = torch.where(under, u_mid, u_a), torch.where(under, u_b,
                                                               u_mid)
    B = _phi_inv(-torch.exp(u_b)[:, None], bmin_, phi_b, Q, gamma, h, B_max,
                 p_tx, N0, hp)
    B = torch.where(A, B, 0.0)

    # residual rounding slack (keeps Σ = B_max): over unpinned clients if
    # any, else over all participants
    slack = B_max - B.sum(-1)                             # [P]
    freem = A & (B > bmin_ + TOL_B)
    nfree = freem.sum(-1)
    add = torch.where((nfree > 0)[:, None],
                      freem * (slack / torch.clamp_min(nfree, 1))[:, None],
                      Af * (slack / torch.clamp_min(U, 1))[:, None])
    B_kkt = torch.where(A, torch.maximum(B + add, bmin_), 0.0)

    B_eq = torch.where(A, bmin_, 0.0)
    # all-participants-Q≤0: objective flat, split the slack evenly
    B_q0 = torch.where(
        A, bmin_ + ((B_max - total_min) / torch.clamp_min(U, 1))[:, None],
        0.0)
    B = torch.where(at_eq[:, None], B_eq,
                    torch.where(active.any(-1)[:, None], B_kkt, B_q0))
    return torch.where(feasible[:, None], B, 0.0), feasible


def objective(A, B, feasible, data):
    """J₂(a) = V·(Theorem-1 objective) + Σ_k a_k Q_k (e_com + e_cmp);
    infeasible rows → +inf (``jaxsolver.objective_batch``)."""
    A = A.to(torch.bool)
    Af = A.to(B.dtype)
    r = rate(torch.clamp_min(B, B_LO), data["h"], data["p_tx"], data["N0"])
    tcom = torch.where(A, data["gamma"] / torch.clamp_min(r, 1e-30), 0.0)
    energy = (Af * data["Q"] * (data["p_tx"] * tcom
                                + data["e_cmp"])).sum(-1)
    bound = objective_batched(Af, data["zeta2"], data["delta2"],
                              data["wbar"], data["has"], data["D"],
                              data["eta"], data["rho"])
    return torch.where(feasible, data["V"] * bound + energy, math.inf)


def population_objective(A, bmin_, ok, data, hp: SolverHyper,
                         want_B: bool = False):
    """(J [P], B [P, K] or None, feasible [P]) for the population A [P, K]
    bool: ``allocate`` followed by ``objective``."""
    B, feasible = allocate(A, bmin_, ok, data, hp)
    J = objective(A, B, feasible, data)
    return J, (B if want_B else None), feasible
