"""Inputs for holding the solver kernels against their plain versions on a
card, shared by ``chip_smoke.py`` and the ``gpu`` tests:

* ``synthetic_round`` — one round's solver data at K clients from the
  port's own modules (numpy, ``build_solver_data``'s dict);
* ``antibody_rows``   — P antibody rows of 1-5 clients each, with the empty
  row first and the full row last;
* ``plain_versions``  — routes the kernel wrappers to their plain versions
  while open, so a whole solve can run both ways on the same card tensors.
  The port never does this: on a card ``ops.py`` always launches.
"""
from __future__ import annotations

import contextlib

import numpy as np

from . import ops, ref


def synthetic_round(K: int, seed: int, Q=None, B_max=None) -> dict:
    """Mixed modalities, perturbed trackers, queues in (0, 0.01) unless
    ``Q`` is given, and the last client latency-infeasible (a channel too
    weak for its upload)."""
    from ...core.aggregation import unified_weights
    from ...core.convergence import BoundState
    from ...wireless.channel import Channel
    from ...wireless.cost import client_costs
    from ...wireless.params import MODALITY_PROFILES, WirelessParams
    from ...wireless.solver import build_solver_data
    rng = np.random.default_rng(seed)
    params = WirelessParams(K=K)
    mods = ([("audio", "image"), ("audio",), ("image",)] * K)[:K]
    sizes = [int(n) for n in rng.integers(20, 80, K)]
    cc = client_costs(sizes, mods, MODALITY_PROFILES["crema_d"], params)
    bound = BoundState(K, ["audio", "image"], mods,
                       unified_weights(sizes, mods, ["audio", "image"]),
                       sizes)
    for m in bound.mods:
        bound.zeta[m] = float(rng.uniform(0.5, 2.0))
        bound.delta[m] = rng.uniform(0.1, 0.6, K)
    h = Channel(params, rng).draw()
    h[-1] = 1e-16
    data = build_solver_data(h, rng.uniform(0, 0.01, K) if Q is None else Q,
                             cc, params, bound, 1.0)
    if B_max is not None:
        data["B_max"] = B_max
    return data


def antibody_rows(K: int, P: int, seed: int) -> np.ndarray:
    """P rows [P, K] bool of 1-5 clients each (denser rows are infeasible
    at K ≥ 10: Σ B_min passes B_max); row 0 empty, and for P > 1 the last
    row full."""
    rng = np.random.default_rng(seed)
    A = np.zeros((P, K), bool)
    for i in range(P):
        A[i, rng.choice(K, min(K, 1 + i % 5), replace=False)] = True
    A[0] = False
    if P > 1:
        A[-1] = True
    return A


@contextlib.contextmanager
def plain_versions():
    """``ops.bmin`` and ``ops.population_objective`` run the plain versions
    while open, on whatever device their tensors are."""
    saved = (ops.bmin, ops.population_objective)

    def population_objective(A, bmin_, ok, data, hp, want_B=False,
                             args=None):
        return ref.population_objective(A, bmin_, ok, data, hp, want_B)

    def bmin(gamma, h, tau_rem, B_max, p_tx, N0, hp, args=None):
        return ref.bmin(gamma, h, tau_rem, B_max, p_tx, N0, hp)

    ops.bmin, ops.population_objective = bmin, population_objective
    try:
        yield
    finally:
        ops.bmin, ops.population_objective = saved
