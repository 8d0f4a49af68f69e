"""Lyapunov virtual energy queues (§V-A).

Q_k^{t+1} = max(Q_k^t − q_k^t, 0) with q_k = E_add − a_k (e_com + e_cmp).
Mean-rate stability of Q is equivalent to the long-term energy constraint C5
(Eq. 29); the drift-plus-penalty weight V trades energy for MFL performance
(Fig. 4).
"""
from __future__ import annotations

import numpy as np


def queue_update(Q, used, E_add):
    """Pure functional Q_k^{t+1} = max(Q_k − (E_add − used_k), 0), where
    ``used_k = a_k (e_com_k + e_cmp_k)`` is the round's actual energy draw.

    ``EnergyQueues.step`` is the stateful host-side twin used by the FL
    runtime."""
    Qn = Q - (E_add - used)
    return Qn * (Qn > 0)


class EnergyQueues:
    def __init__(self, K: int):
        self.Q = np.zeros(K)
        self.spent = np.zeros(K)       # cumulative actual energy [J]
        self.t = 0

    def step(self, a: np.ndarray, e_com: np.ndarray, e_cmp: np.ndarray,
             E_add: float) -> np.ndarray:
        a = np.asarray(a, float)
        used = a * (e_com + e_cmp)
        self.Q = np.asarray(queue_update(self.Q, used, E_add))
        self.spent += used
        self.t += 1
        return E_add - used

    def mean_queue(self) -> float:
        return float(self.Q.mean())

    def stability_metric(self) -> float:
        """|Q^T|/T → 0 is C5' (Eq. 29)."""
        return float(np.abs(self.Q).mean() / max(self.t, 1))
