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
``update`` (the sequential loop) and ``update_stacked`` (the batched loop)
reduce the gradients on their device and bring only the norms to the
host.  The fused round keeps ζ/δ as tensors in its carry and refreshes them
with the ``tracker_update_*`` functions below, which read nothing back.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .trees import tree_leaves, tree_map, tree_norm, tree_sq_norm


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
    def update(self, grads_by_client: List[Optional[Mapping[str, dict]]],
               agg_grads: Mapping[str, dict]) -> None:
        """Refresh ζ/δ from the gradients uploaded this round
        (``grads_by_client[k]``: client k's {modality: grads}, or None)."""
        for m in self.mods:
            if m not in agg_grads:
                continue
            self.zeta[m] = float(tree_norm(agg_grads[m]))
            seen = []
            for k, g in enumerate(grads_by_client):
                if g is None or m not in g:
                    continue
                self.delta[m][k] = float(tree_norm(tree_map(
                    torch.sub, g[m], agg_grads[m])))
                seen.append(k)
            if seen:
                mean_d = float(np.mean([self.delta[m][k] for k in seen]))
                for k in range(self.K):
                    if k not in seen and m in self.client_mods[k]:
                        # decay stale entries toward the fresh mean
                        self.delta[m][k] = (self.staleness * self.delta[m][k]
                                            + (1 - self.staleness) * mean_d)

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

    def descent_bound(self, grad_sq_sum: float, gamma: float,
                      a: np.ndarray) -> float:
        """Full Theorem-2 RHS: −(2η−γη²)/2 Σ‖∇H_m‖² + ηρ√(A₁+A₂)."""
        return (-(2 * self.eta - gamma * self.eta ** 2) / 2.0 * grad_sq_sum
                + self.bound_term(a))

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
# The fused round's ζ/δ refresh: one modality's update as tensor ops with no
# read-back.  Rows with real uploads take their measured divergence, stale
# owners decay toward the fresh mean, and with no upload at all the state is
# unchanged.  Two producers of the partials (ζ_new and the per-row
# divergence norms): ``tracker_partials_diff`` by difference against the
# aggregated gradient, and ``tracker_partials_gram`` from the per-modality
# Gram matrix G = Σ_leaves X Xᵀ and the Eq. 12 weights (ζ² = wᵀGw, δ_j² =
# G_jj − 2(Gw)_j + wᵀGw), which the fused round uses.
# ---------------------------------------------------------------------------
def tracker_partials_diff(stacked_g, agg_g):
    """(ζ_new, per-row ‖g_j − ḡ‖ [J]) by direct difference against the
    aggregate."""
    leaves = tree_leaves(stacked_g)
    lead = leaves[0].shape[0]
    zeta_new = torch.sqrt(tree_sq_norm(agg_g))
    sq = sum(((gs - ga[None]) ** 2).reshape(lead, -1).sum(dim=1)
             for gs, ga in zip(leaves, tree_leaves(agg_g)))
    return zeta_new, torch.sqrt(sq)


def grad_gram(stacked_g):
    """[J, J] Gram matrix G_ij = ⟨g_i, g_j⟩ of a stacked gradient dict,
    summed over leaves (zero rows stay zero rows)."""
    leaves = tree_leaves(stacked_g)
    lead = leaves[0].shape[0]
    return sum(x.reshape(lead, -1) @ x.reshape(lead, -1).T for x in leaves)


def tracker_partials_gram(gram, w):
    """(ζ_new, per-row ‖g_j − ḡ‖) from the Gram matrix and the aggregation
    weights: ζ² = wᵀGw, δ_j² = G_jj − 2(Gw)_j + wᵀGw, clamped at 0 against
    float32 cancellation."""
    w = w.to(gram.dtype)
    gw = gram @ w
    wgw = w @ gw
    zeta_new = torch.sqrt(torch.clamp_min(wgw, 0.0))
    sq = torch.clamp_min(torch.diagonal(gram) - 2.0 * gw + wgw, 0.0)
    return zeta_new, torch.sqrt(sq)


def _tracker_refresh(zeta_m, delta_m, zeta_new, norms_c, mask_c, idx, has_m,
                     staleness: float):
    """Scatter cohort-local divergence norms into the dense [K] δ row
    (``idx`` [J] distinct; the dense path passes ``arange(K)``), decay stale
    owners toward the fresh mean, keep everything when nothing uploaded."""
    mask_c = mask_c.to(torch.bool)
    has_m = has_m.to(torch.bool)
    any_m = mask_c.any()
    mean_d = (norms_c * mask_c).sum() / torch.clamp_min(mask_c.sum(), 1)
    decayed = staleness * delta_m + (1.0 - staleness) * mean_d
    K = delta_m.shape[0]
    idx = idx.to(torch.long)
    uploaded = torch.zeros(K, dtype=torch.bool, device=delta_m.device
                           ).index_copy(0, idx, mask_c)
    norms_k = torch.zeros(K, dtype=delta_m.dtype, device=delta_m.device
                          ).index_copy(0, idx, torch.where(
                              mask_c, norms_c, 0.0).to(delta_m.dtype))
    delta_new = torch.where(uploaded, norms_k,
                            torch.where(has_m & ~uploaded, decayed, delta_m))
    return (torch.where(any_m, zeta_new, zeta_m),
            torch.where(any_m, delta_new, delta_m))


def tracker_update_masked(zeta_m, delta_m, stacked_g, agg_g, mask, has_m,
                          staleness: float):
    """Refresh (ζ_m, δ_{·,m}) from a dense [K]-stacked gradient dict:
    ``agg_g`` is the Eq. 9 aggregate, ``mask``/``has_m`` bool [K]
    (uploaded this round / owns the modality)."""
    zeta_new, norms = tracker_partials_diff(stacked_g, agg_g)
    K = delta_m.shape[0]
    return _tracker_refresh(zeta_m, delta_m, zeta_new, norms, mask,
                            torch.arange(K, device=delta_m.device), has_m,
                            staleness)


def tracker_update_cohort(zeta_m, delta_m, cohort_g, agg_g, mask_c, idx,
                          has_m, staleness: float):
    """``tracker_update_masked`` on a gathered cohort: [J]-leading
    gradients, norms scattered to the dense row through ``idx`` [J];
    ``mask_c`` bool [J] marks real uploads, ``has_m`` bool [K]."""
    zeta_new, norms_c = tracker_partials_diff(cohort_g, agg_g)
    return _tracker_refresh(zeta_m, delta_m, zeta_new, norms_c, mask_c, idx,
                            has_m, staleness)


def tracker_update_gram(zeta_m, delta_m, gram, w_c, mask_c, idx, has_m,
                        staleness: float):
    """The Gram-form cohort refresh the fused round runs: the [J, J] Gram
    matrix (``grad_gram``) and the cohort's Eq. 12 weights ``w_c`` [J] in
    place of gradient stacks."""
    zeta_new, norms_c = tracker_partials_gram(gram, w_c)
    return _tracker_refresh(zeta_m, delta_m, zeta_new, norms_c, mask_c, idx,
                            has_m, staleness)


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
