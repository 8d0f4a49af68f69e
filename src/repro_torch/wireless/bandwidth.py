"""Optimal bandwidth allocation — the continuous subproblem P4.2' (§V-C).

P4.2': min Σ_{k∈K^t} Q_k p Γ_k / r_k(B_k)   s.t.  Σ B_k = B_max,
       r_k(B_k) ≥ Γ_k / (τ_max − τ_cmp_k)   (per-client latency, In1)

The objective is convex (Eq. 38) and the KKT conditions reduce to a
water-filling structure over the multiplier κ (Eqs. 43-48): clients whose
latency constraint binds sit at B_k^min (λ₄>0), the rest satisfy
φ_k(B_k) = κ* where φ_k = ∂J₃/∂B_k (Eq. 37, negative & increasing in B).

The paper enumerates the sorted κ intervals and runs Newton per interval; we
solve the *same* KKT system by bisection on κ* — Σ_k B_k(κ) is monotone
increasing in κ, so the bisection converges to the unique KKT point with the
same O(U log 1/ε) inner work.  Equivalence is asserted against a brute-force
projected-grid optimiser in tests/test_bandwidth.py.

This module is the scalar *sequential* path (one candidate schedule per
call, adaptive-termination loops, ``None`` for infeasibility) that
``schedulers.JCSBAScheduler(solver="seq")`` runs.  A numpy copy of the JAX
package's module, so both packages allocate bandwidth bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .params import WirelessParams
from .channel import rate_ceiling

_TOL_B = 1.0          # [Hz] absolute bandwidth tolerance
_MAX_IT = 200


def _rate(B: float, h: float, p: WirelessParams) -> float:
    if B <= 0:
        return 0.0
    return B * np.log1p(p.p_tx * h / (B * p.N0)) / np.log(2.0)


def phi(B: float, Q: float, gamma: float, h: float, p: WirelessParams) -> float:
    """φ = ∂J₃/∂B (Eq. 37). Negative, strictly increasing in B, → 0⁻."""
    x = p.p_tx * h / (B * p.N0)
    ln1x = np.log1p(x)
    num = x / (1.0 + x) - ln1x
    return Q * p.p_tx * gamma * np.log(2.0) * num / (B * B * ln1x * ln1x)


def b_min(gamma: float, h: float, tau_rem: float,
          p: WirelessParams) -> Optional[float]:
    """Unique B with r(B) = Γ/τ_rem (Eq. 41); None if infeasible."""
    if tau_rem <= 0:
        return None
    target = gamma / tau_rem
    if target >= rate_ceiling(np.array([h]), p)[0] * (1 - 1e-12):
        return None                       # even infinite bandwidth can't do it
    lo, hi = 1e-3, 1e4
    while _rate(hi, h, p) < target:
        hi *= 4.0
        if hi > 1e16:
            return None
    for _ in range(_MAX_IT):
        mid = 0.5 * (lo + hi)
        if _rate(mid, h, p) < target:
            lo = mid
        else:
            hi = mid
        if hi - lo < _TOL_B * 1e-3:
            break
    return hi


def _phi_inv(kappa: float, bmin_k: float, Q: float, gamma: float, h: float,
             p: WirelessParams) -> float:
    """B ≥ B_min with φ(B) = κ; clamps to B_min when φ(B_min) ≥ κ (E1/E2)."""
    if phi(bmin_k, Q, gamma, h, p) >= kappa:
        return bmin_k
    lo, hi = bmin_k, max(2 * bmin_k, 1e4)
    while phi(hi, Q, gamma, h, p) < kappa:
        hi *= 4.0
        if hi > 1e18:
            return hi
    for _ in range(_MAX_IT):
        mid = 0.5 * (lo + hi)
        if phi(mid, Q, gamma, h, p) < kappa:
            lo = mid
        else:
            hi = mid
        if hi - lo < _TOL_B * 1e-3:
            break
    return 0.5 * (lo + hi)


def allocate(Q: np.ndarray, gamma: np.ndarray, h: np.ndarray,
             tau_rem: np.ndarray, p: WirelessParams) -> Optional[np.ndarray]:
    """Solve P4.2' for the participating clients.

    All arrays are over the participant set K^t.  Returns B* (same length) or
    None if the participation vector is infeasible (Eq. 42 violated).
    """
    U = len(Q)
    if U == 0:
        return np.zeros(0)
    bmins = np.empty(U)
    for i in range(U):
        b = b_min(gamma[i], h[i], tau_rem[i], p)
        if b is None:
            return None
        bmins[i] = b
    total_min = bmins.sum()
    if total_min > p.B_max + _TOL_B:
        return None                                   # (42) unsatisfied
    if total_min >= p.B_max - _TOL_B:
        return bmins                                  # (42) holds with equality
    # Q=0 clients have φ ≡ 0 ≥ κ for any κ<0: they stay at B_min.  If every
    # participant has Q=0 the objective is flat — split the slack evenly.
    if np.all(Q <= 0):
        return bmins + (p.B_max - total_min) / U

    def total(kappa: float) -> float:
        return sum(_phi_inv(kappa, bmins[i], Q[i], gamma[i], h[i], p)
                   for i in range(U))

    k_lo = min(phi(bmins[i], Q[i], gamma[i], h[i], p)
               for i in range(U) if Q[i] > 0)
    k_hi = -1e-300
    for _ in range(_MAX_IT):
        k_mid = 0.5 * (k_lo + k_hi) if k_hi < 0 else k_lo / 2
        t = total(k_mid)
        if t < p.B_max:
            k_lo = k_mid
        else:
            k_hi = k_mid
        if abs(t - p.B_max) < _TOL_B:
            break
    B = np.array([_phi_inv(k_hi, bmins[i], Q[i], gamma[i], h[i], p)
                  for i in range(U)])
    # distribute any residual rounding slack proportionally (keeps Σ=B_max)
    slack = p.B_max - B.sum()
    free = B > bmins + _TOL_B
    if slack != 0 and free.any():
        B[free] += slack / free.sum()
    elif slack != 0:
        B += slack / U
    return np.maximum(B, bmins)
