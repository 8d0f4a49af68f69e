# Frozen copy of src/repro/wireless/params.py (numpy only), kept verbatim so the
# reference derives the same inputs from the seed without importing the
# program.  Edited only where it imported its package.
"""Wireless system parameters — paper Table 2, plus simulation constants.

All Table-2 values are kept verbatim.  Constants the paper does not publish
(composite antenna/other gains folded into h_k, β₀ fusion cycles, the fading
law) are documented here and in DESIGN.md §8.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class WirelessParams:
    # Table 2 (verbatim)
    B_max: float = 10e6                 # total uplink bandwidth [Hz]
    tau_max: float = 0.01               # per-round latency budget [s]
    p_tx_dbm: float = 23.0              # uplink transmit power [dBm]
    N0_dbm_hz: float = -174.0           # noise PSD [dBm/Hz]
    K: int = 10                         # clients
    E_add: float = 0.01                 # per-round energy allowance [J]
    f_cpu: float = 1.55e9               # CPU frequency [Hz]
    alpha: float = 1e-27                # energy coefficient
    # Simulation constants (not in Table 2)
    cell_radius_m: float = 500.0
    extra_gain_db: float = 60.0         # BS+UE antenna & other gains folded in
    beta0: float = 100.0                # fusion CPU cycles per sample pair

    @property
    def p_tx(self) -> float:
        return 10 ** (self.p_tx_dbm / 10) / 1000.0          # [W]

    @property
    def N0(self) -> float:
        return 10 ** (self.N0_dbm_hz / 10) / 1000.0         # [W/Hz]


# Per-modality upload bits l_m and per-sample CPU cycles beta_m (Table 2).
MODALITY_PROFILES: Dict[str, Dict[str, Tuple[float, float]]] = {
    "crema_d": {
        "audio": (562400.0, 2000.0),
        "image": (557056.0, 8000.0),
    },
    "iemocap": {
        "audio": (562400.0, 2000.0),
        "text": (1145280.0, 4500.0),
    },
}


def upload_bits(modalities, profile: Dict[str, Tuple[float, float]]) -> float:
    """Γ_k = Σ_{m∈M_k} l_m (Eq. 15)."""
    return float(sum(profile[m][0] for m in modalities))


def cpu_cycles_per_sample(modalities, profile, beta0: float) -> float:
    """Φ_k = Σ_{m∈M_k}(β_m + β₀) − β₀ (Eq. 17)."""
    mods = list(modalities)
    if not mods:
        return 0.0
    return float(sum(profile[m][1] + beta0 for m in mods) - beta0)
