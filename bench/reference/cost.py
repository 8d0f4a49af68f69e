# Frozen copy of src/repro/wireless/cost.py (numpy only), cut to what the
# reference calls, so that it derives the same costs from the seed without
# importing the program.  Edited only where it imported its package.
"""Latency & energy models — Eqs. (15)-(20)."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .params import WirelessParams, cpu_cycles_per_sample, upload_bits


@dataclasses.dataclass
class ClientCost:
    """Static per-client quantities (channel-independent)."""
    gamma_bits: np.ndarray      # Γ_k upload size [bit]
    tau_cmp: np.ndarray         # computation latency [s] (Eq. 17)
    e_cmp: np.ndarray           # computation energy [J] (Eq. 18)


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
