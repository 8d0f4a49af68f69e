"""Convergence-bound bookkeeping — Theorem 1 / Theorem 2 of the paper.

Theorem 1 bounds H(θ^t) − H(ψ^t) ≤ ηρ √(A₁ + A₂) with

    A₁ = Σ_{m ∉ M^t} (ζ_m^{t-1})²                       (unscheduled modality)
    A₂ = Σ_{m ∈ M^t} 2 (1 − Σ_{k∈K_m} a_k w̄_{k,m}) ·
         Σ_{k∈K_m} (w^t_{k,m} + w̄_{k,m} − 2 a_k w̄_{k,m}) (δ_{k,m}^{t-1})²

ζ and δ are tracked from the gradients uploaded in previous rounds:

    ζ_m   ← ‖∇H(θ_{g,m})‖        (norm of the aggregated unimodal subgradient)
    δ_k,m ← ‖∇H_k(θ_{g,m}) − ∇H(θ_{g,m})‖   (client-to-global divergence)

Stale entries decay toward the modality mean so never-scheduled clients stay
schedulable.  ``objective(a)`` is the V-weighted term of the JCSBA objective
J₁ (P3, Eq. 32).

The tracker state and the bound are host numpy, as in the JAX package;
``update_stacked`` reduces the [K, ...] gradient stacks on their device and
brings only the [K] norms to the host.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .trees import tree_leaves, tree_norm


class BoundState:
    """Tracks ζ_m and δ_{k,m} and evaluates the Theorem-1 bound."""

    def __init__(self, n_clients: int, all_modalities: Sequence[str],
                 client_modalities: Sequence[Sequence[str]],
                 unified_w: Mapping[str, np.ndarray],
                 data_sizes: Sequence[int],
                 eta: float = 0.1, rho: float = 1.0,
                 init_zeta: float = 1.0, init_delta: float = 0.3,
                 staleness: float = 0.9):
        # init_delta < init_zeta: the cold-start bound must prefer scheduling
        # over idling (otherwise round 0 schedules nobody and the trackers
        # never update)
        self.K = n_clients
        self.mods = list(all_modalities)
        self.client_mods = [set(m) for m in client_modalities]
        self.w_bar = {m: np.asarray(unified_w[m], np.float64)
                      for m in self.mods}
        self.D = np.asarray(data_sizes, np.float64)
        self.eta, self.rho = eta, rho
        self.zeta = {m: init_zeta for m in self.mods}
        self.delta = {m: np.full(n_clients, init_delta) for m in self.mods}
        self.staleness = staleness

    # ------------------------------------------------------------------
    def update_stacked(self, stacked_grads: Mapping[str, dict],
                       upload_mask: Mapping[str, np.ndarray],
                       agg_grads: Mapping[str, dict]) -> None:
        """Refresh ζ/δ from this round's uploads: ``stacked_grads[m]`` leaves
        carry a leading client axis [K, ...] and ``upload_mask[m]`` (bool
        [K]) marks which rows are real uploads — masked-out rows hold exact
        zeros and are ignored."""
        for m in self.mods:
            if m not in agg_grads:
                continue
            mask = np.asarray(upload_mask[m], bool)
            seen = np.flatnonzero(mask)
            if not seen.size:
                continue
            self.zeta[m] = float(tree_norm(agg_grads[m]))
            sq = sum(((gs - ga[None]) ** 2).reshape(self.K, -1).sum(dim=1)
                     for gs, ga in zip(tree_leaves(stacked_grads[m]),
                                       tree_leaves(agg_grads[m])))
            norms = torch.sqrt(sq).cpu().numpy()
            self.delta[m][seen] = norms[seen]
            mean_d = float(norms[seen].mean())
            stale = np.array([m in cm for cm in self.client_mods]) & ~mask
            self.delta[m][stale] = (self.staleness * self.delta[m][stale]
                                    + (1 - self.staleness) * mean_d)

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, np.ndarray]:
        """Dense-array view of the tracker state for the batched solver:
        everything ``a1_a2`` / ``objective`` read from Python dicts, packed
        into [M]/[M, K] arrays so the Theorem-1 term can be evaluated for a
        whole antibody population at once (``objective_batched``).  A fresh
        snapshot must be taken every round — ζ/δ move whenever
        ``update_stacked`` runs."""
        M, K = len(self.mods), self.K
        has = np.zeros((M, K), bool)
        for i, m in enumerate(self.mods):
            for k in range(K):
                has[i, k] = m in self.client_mods[k]
        return {
            "zeta2": np.array([self.zeta[m] ** 2 for m in self.mods]),
            "delta2": np.stack([np.square(self.delta[m])
                                for m in self.mods]) if M else
                      np.zeros((0, K)),
            "wbar": np.stack([self.w_bar[m] for m in self.mods]) if M else
                    np.zeros((0, K)),
            "has": has,
            "D": self.D,
        }

    def a1_a2(self, a: np.ndarray) -> tuple:
        """A₁, A₂ of Theorem 1 for participation vector a ∈ {0,1}^K."""
        a = np.asarray(a, np.float64)
        A1 = 0.0
        A2 = 0.0
        for m in self.mods:
            has = np.array([m in cm for cm in self.client_mods], bool)
            part = has & (a > 0.5)
            if not part.any():                      # m ∉ M^t
                A1 += self.zeta[m] ** 2
                continue
            wbar = self.w_bar[m]
            wt = np.where(part, self.D, 0.0)
            wt = wt / wt.sum()
            cover = float((a * wbar).sum())         # Σ a_k w̄_{k,m}
            coeff = wt + wbar - 2.0 * a * wbar
            A2 += 2.0 * (1.0 - cover) * float(
                (coeff * np.square(self.delta[m])).sum())
        return A1, max(A2, 0.0)

    def bound_term(self, a: np.ndarray) -> float:
        """ηρ√(A₁+A₂) — the scheduling-dependent part of Theorem 2."""
        A1, A2 = self.a1_a2(a)
        return self.eta * self.rho * float(np.sqrt(A1 + A2))

    def objective(self, a: np.ndarray, gamma: float = 1.0) -> float:
        """Scheduling objective = Theorem-2 RHS restricted to a-dependent
        terms, including the descent credit −(2η−γη²)/2·ζ_m² of each covered
        modality (the JAX package's implementation refinement, kept so both
        packages schedule alike)."""
        a = np.asarray(a, np.float64)
        A1, A2 = self.a1_a2(a)
        covered = 0.0
        for m in self.mods:
            has = np.array([m in cm for cm in self.client_mods], bool)
            if (has & (a > 0.5)).any():
                covered += self.zeta[m] ** 2
        c = (2 * self.eta - gamma * self.eta ** 2) / 2.0
        return (self.eta * self.rho * float(np.sqrt(A1 + A2))
                - c * covered)


# ---------------------------------------------------------------------------
# The Theorem-1 term for a whole antibody population A ∈ {0,1}^{P×K}, in
# float32 tensors on A's device — the plain version the solver's population
# kernel (kernels/jcsba_solver) holds its bound term against.
# ---------------------------------------------------------------------------
def a1_a2_batched(A, zeta2, delta2, wbar, has, D):
    """A₁, A₂ of Theorem 1 for a population.

    A: [P, K] (bool or 0/1 float); snapshot tensors as from
    ``BoundState.snapshot()`` (``has`` bool).  Returns (A1 [P], A2 [P])."""
    Af = torch.as_tensor(A).to(torch.float32)
    part = has[None] & (Af[:, None, :] > 0.5)             # [P, M, K]
    sched = part.any(-1)                                  # m ∈ M^t   [P, M]
    A1 = ((~sched) * zeta2).sum(-1)
    wt_raw = torch.where(part, D, 0.0)                    # w^t_{k,m} numerator
    denom = wt_raw.sum(-1, keepdim=True)
    wt = torch.where(denom > 0, wt_raw / torch.clamp_min(denom, 1e-30), 0.0)
    cover = (Af[:, None, :] * wbar).sum(-1)               # Σ a_k w̄_{k,m}
    coeff = wt + wbar - 2.0 * Af[:, None, :] * wbar
    A2_m = 2.0 * (1.0 - cover) * (coeff * delta2).sum(-1)
    A2 = torch.clamp_min((sched * A2_m).sum(-1), 0.0)
    return A1, A2


def objective_batched(A, zeta2, delta2, wbar, has, D,
                      eta: float, rho: float, gamma: float = 1.0):
    """Population twin of ``BoundState.objective`` — ηρ√(A₁+A₂) minus the
    descent credit of covered modalities.  Returns [P] float32."""
    Af = torch.as_tensor(A).to(torch.float32)
    A1, A2 = a1_a2_batched(Af, zeta2, delta2, wbar, has, D)
    sched = (has[None] & (Af[:, None, :] > 0.5)).any(-1)
    covered = (sched * zeta2).sum(-1)
    c = (2 * eta - gamma * eta ** 2) / 2.0
    return eta * rho * torch.sqrt(A1 + A2) - c * covered
