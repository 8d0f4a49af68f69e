"""Immune algorithm for the combinatorial scheduling subproblem P4.1
(Algorithm 2 of the paper).

Antibody = participation vector a ∈ {0,1}^K.  Affinity derives from J₂(a)
(Eq. 50, infeasible → 0); concentration (Eq. 51-52) uses the Hamming-distance
similarity threshold Dis; the incentive (Eq. 53) trades affinity against
concentration to preserve diversity.  Default hyper-parameters follow
Algorithm 2's header: S=20, G=10, μ=5, z=0.175.

The paper returns the best antibody of the final generation; we additionally
keep the best *feasible* antibody seen across generations (never worse).
Objective evaluations are memoised — the bandwidth KKT solve dominates the
cost, and clones repeat genotypes frequently.

This is the *sequential* search (one eval_fn call per antibody), the
``solver="seq"`` backend of ``schedulers.JCSBAScheduler``.  It draws only
from the experiment's numpy ``Generator``, a fixed number of values per call,
so the port consumes the same host stream as the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np


def immune_search(eval_fn: Callable[[np.ndarray], float],
                  K: int,
                  rng: np.random.Generator,
                  S: int = 20, G: int = 10, mu: int = 5, z: float = 0.175,
                  iota: float = 4.0, dis: int = 2,
                  eps1: float = 1.0, eps2: float = 0.15,
                  seed_antibodies: Optional[np.ndarray] = None,
                  ) -> Tuple[np.ndarray, float]:
    """Minimise eval_fn(a) (np.inf = infeasible). Returns (a*, J*)."""
    memo: Dict[bytes, float] = {}

    def J(a: np.ndarray) -> float:
        key = np.packbits(a).tobytes()
        if key not in memo:
            memo[key] = float(eval_fn(a))
        return memo[key]

    pop = rng.integers(0, 2, (S, K)).astype(bool)
    if seed_antibodies is not None:
        n = min(len(seed_antibodies), S)
        pop[:n] = seed_antibodies[:n]

    best_a, best_J = None, np.inf
    n_elite = max(S // mu, 1)
    n_keep = S - n_elite

    def affinity(vals: np.ndarray) -> np.ndarray:
        finite = np.isfinite(vals)
        if not finite.any():
            return np.zeros_like(vals)
        jmax, jmin = vals[finite].max(), vals[finite].min()
        span = max(jmax - jmin, 1e-12)
        aff = np.where(finite, ((jmax - vals) / span + 1e-6) ** iota, 0.0)
        return aff

    for g in range(G):
        vals = np.array([J(a) for a in pop])
        imin = int(np.argmin(vals))
        if vals[imin] < best_J:
            best_J, best_a = vals[imin], pop[imin].copy()

        aff = affinity(vals)
        ham = (pop[:, None, :] != pop[None, :, :]).sum(-1)
        con = (ham <= dis).mean(axis=1)                       # Eq. 51-52
        inc = eps1 * aff - eps2 * con                         # Eq. 53

        elite_idx = np.argsort(-inc)[:n_elite]
        elites = pop[elite_idx]
        clones = np.repeat(elites, mu, axis=0)                # μ-fold cloning
        mut = rng.random(clones.shape) < z
        mutants = clones ^ mut
        cand = np.concatenate([mutants, elites], axis=0)
        cand_vals = np.array([J(a) for a in cand])
        cand_aff = affinity(cand_vals)
        keep = cand[np.argsort(-cand_aff)[:n_keep]]
        fresh = rng.integers(0, 2, (S - n_keep, K)).astype(bool)
        pop = np.concatenate([keep, fresh], axis=0)

    # final generation check
    vals = np.array([J(a) for a in pop])
    imin = int(np.argmin(vals))
    if vals[imin] < best_J:
        best_J, best_a = vals[imin], pop[imin].copy()
    if best_a is None:                                        # all infeasible
        best_a = np.zeros(K, bool)
        best_J = J(best_a)
    return best_a, best_J
