"""Latency & energy models — Eqs. (15)-(20)."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .params import WirelessParams, cpu_cycles_per_sample, upload_bits
from .channel import uplink_rate


@dataclasses.dataclass
class ClientCost:
    """Static per-client quantities (channel-independent)."""
    gamma_bits: np.ndarray      # Γ_k upload size [bit]
    tau_cmp: np.ndarray         # computation latency [s] (Eq. 17)
    e_cmp: np.ndarray           # computation energy [J] (Eq. 18)

    def tau_residual(self, params: WirelessParams) -> np.ndarray:
        """τ_max − τ_cmp_k — the communication-latency budget left per client
        (the RHS denominator of the In1 constraint in P4.2')."""
        return params.tau_max - self.tau_cmp


def client_costs(data_sizes: Sequence[int],
                 client_modalities: Sequence[Sequence[str]],
                 profile, params: WirelessParams) -> ClientCost:
    K = len(data_sizes)
    gam = np.zeros(K)
    tcmp = np.zeros(K)
    ecmp = np.zeros(K)
    for k in range(K):
        gam[k] = upload_bits(client_modalities[k], profile)
        phi = cpu_cycles_per_sample(client_modalities[k], profile, params.beta0)
        tcmp[k] = data_sizes[k] * phi / params.f_cpu
        ecmp[k] = params.alpha * data_sizes[k] * params.f_cpu ** 2 * phi
    return ClientCost(gam, tcmp, ecmp)


def population_costs(has_modality, modalities: Sequence[str],
                     sizes: np.ndarray, profile,
                     params: WirelessParams) -> ClientCost:
    """Vectorized Eqs. 15-18 over ownership masks — ``client_costs`` without
    the per-client Python loop, for O(10⁴–10⁶) populations.

    ``has_modality[m]`` is a bool [K] ownership mask (a ``ClientStore``
    field), ``sizes`` the per-client sample counts D_k."""
    has = {m: np.asarray(has_modality[m], bool) for m in modalities}
    # Γ_k = Σ_{m∈M_k} l_m (Eq. 15);  Φ_k = Σ_{m∈M_k}(β_m + β₀) − β₀ (Eq. 17)
    gam = sum(np.where(has[m], profile[m][0], 0.0) for m in modalities)
    owned = sum(has[m].astype(np.int64) for m in modalities)
    phi = (sum(np.where(has[m], profile[m][1] + params.beta0, 0.0)
               for m in modalities)
           - params.beta0 * (owned > 0))
    D = np.asarray(sizes, np.float64)
    tau_cmp = D * phi / params.f_cpu                                # Eq. 17
    e_cmp = params.alpha * D * params.f_cpu ** 2 * phi              # Eq. 18
    return ClientCost(np.asarray(gam, np.float64), tau_cmp, e_cmp)


def com_latency(B: np.ndarray, h: np.ndarray, gamma_bits: np.ndarray,
                params: WirelessParams) -> np.ndarray:
    """τ_k^com = Γ_k / r_k (Eq. 15)."""
    r = uplink_rate(B, h, params)
    with np.errstate(divide="ignore"):
        t = gamma_bits / np.maximum(r, 1e-300)
    return np.where(B > 0, t, np.inf)


def com_energy(tau_com: np.ndarray, params: WirelessParams) -> np.ndarray:
    """e_k^com = p τ_k^com (Eq. 16)."""
    return params.p_tx * np.where(np.isfinite(tau_com), tau_com, 0.0)


def residual_energy(a: np.ndarray, e_com: np.ndarray, e_cmp: np.ndarray,
                    params: WirelessParams) -> np.ndarray:
    """q_k = E_add − a_k (e_com + e_cmp) (§III-C)."""
    return params.E_add - a * (e_com + e_cmp)
