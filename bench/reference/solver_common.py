# Frozen copy of src/repro/wireless/solver/common.py (numpy only), cut to
# what the reference calls, so that it solves as the JAX package's numpy
# solver does without importing the program.  Edited only where it imported
# its package.
"""Shared pieces of the batched JCSBA solver backends.

The solver evaluates a whole antibody population A ∈ {0,1}^{P×K} per
generation: the KKT bandwidth subproblem (P4.2') is a fixed-iteration
bisection vmapped over candidates and masked over participants, and the
Theorem-1 bound term + Lyapunov energy term fuse into the same program.

Two backends implement the identical algorithm on the identical random draws
(``jax.random`` bits, see ``jaxsolver.make_draws``):

* ``ref.py``       — float64 numpy, the readable reference;
* ``jaxsolver.py`` — float32 jnp, one jitted program per round.

Parity between them (and against the legacy scalar ``bandwidth.allocate`` /
``immune.immune_search`` path, kept as ``solver="seq"``) is asserted in
``tests/test_solver_parity.py``.

Numerical conventions shared by both backends (mirrored exactly so the two
trajectories stay bit-comparable up to float32 rounding):

* bisections run a *fixed* iteration count on a *fixed* bracket instead of
  the legacy expand-then-break loops.  The brackets exploit that no useful
  allocation exceeds B_max: φ⁻¹ bisects on [B_min, B_max] (every B_k ≤ B_max
  at the KKT point, so clamping there never moves the κ root) and the B_min
  solve bisects on [B_LO, 2·B_max] — a B_min driven to the cap just renders
  the candidate infeasible via the Σ B_min ≤ B_max check (Eq. 42), where only
  "> B_max", not the magnitude, matters;
* the κ bisection runs in log(−κ) space: κ* spans many decades (φ values from
  ~−1e9 down to ~−1e-20) and linear halving cannot resolve that in a fixed
  budget;
* φ's small-x cancellation (x/(1+x) − log1p(x) for x ≪ 1) is replaced by its
  series −x²/2 + (2/3)x³ − (3/4)x⁴ below ``PHI_SERIES_X`` so float32 keeps
  ~5 significant digits;
* B_min is inflated by ``BMIN_SAFETY`` so float32 allocations keep a real
  latency margin (the runtime's feasibility check is strict).
"""
from __future__ import annotations

import dataclasses

import numpy as np

TOL_B = 1.0            # [Hz] — same absolute tolerance as bandwidth._TOL_B
B_LO = 1e-3            # [Hz] lower bracket end for the B_min bisection
B_CAP = 1e12           # [Hz] sentinel B_min for latency-infeasible clients
BMIN_SAFETY = 1e-4     # relative inflation of B_min (float32 latency margin)
KAPPA_TINY = 1e-30     # |κ| upper-bracket end (κ → 0⁻)
PHI_SERIES_X = 0.02    # switch φ's numerator to its series below this x


@dataclasses.dataclass(frozen=True)
class SolverHyper:
    """Immune-search hyper-parameters (Algorithm 2 header) + fixed iteration
    budgets for the bisections.  Frozen/hashable so it can be a static jit
    argument."""
    S: int = 20            # population size
    G: int = 10            # generations
    mu: int = 5            # clone factor
    z: float = 0.175       # mutation probability
    iota: float = 4.0      # affinity sharpening exponent
    dis: int = 2           # Hamming similarity threshold (Eq. 51)
    eps1: float = 1.0      # incentive: affinity weight (Eq. 53)
    eps2: float = 0.15     # incentive: concentration weight (Eq. 53)
    n_bisect_b: int = 30   # iterations for every B-space bisection
    n_bisect_k: int = 40   # iterations for the log-space κ bisection

    @property
    def n_elite(self) -> int:
        return max(self.S // self.mu, 1)

    @property
    def n_clones(self) -> int:
        return self.n_elite * self.mu

    @property
    def n_cand(self) -> int:
        return self.n_clones + self.n_elite

    @property
    def n_keep(self) -> int:
        # never more than the clone+elite pool provides (small S with large μ)
        return min(self.S - self.n_elite, self.n_cand)

    @property
    def n_fresh(self) -> int:
        return self.S - self.n_keep
