# Frozen copy of src/repro/wireless/channel.py (numpy only), cut to what the
# reference calls, so that it draws the same channel from the seed without
# importing the program.  Edited only where it imported its package.
"""Cellular uplink channel simulation (§III-A / §VI setup).

K clients uniform in a 500 m disc around the BS; channel gain h_k combines
3GPP log-distance path loss (128.1 + 37.6·log10 d_km), Rayleigh small-scale
fading (redrawn every communication round) and a composite antenna/other gain
(``extra_gain_db`` — the paper folds these into h_k without publishing them).
"""
from __future__ import annotations

import numpy as np

from .params import WirelessParams


class Channel:
    def __init__(self, params: WirelessParams, rng: np.random.Generator):
        self.params = params
        self.rng = rng
        r = params.cell_radius_m * np.sqrt(rng.uniform(0.02, 1.0, params.K))
        self.dist_m = r                                     # BS at the centre

    def path_gain(self) -> np.ndarray:
        pl_db = 128.1 + 37.6 * np.log10(self.dist_m / 1000.0)
        return 10 ** ((-pl_db + self.params.extra_gain_db) / 10.0)

    def draw(self) -> np.ndarray:
        """h_k for one communication round (large-scale x Rayleigh power)."""
        rayleigh_power = self.rng.exponential(1.0, self.params.K)
        return self.path_gain() * rayleigh_power
