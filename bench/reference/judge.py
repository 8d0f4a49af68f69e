"""How good a JCSBA schedule is, judged against the reference's own search.

The immune search (Algorithm 2) keeps elites by their objective J₂, and
the experiment's clients often tie or nearly tie: which antibody a search
keeps then rests on rounding, and from there it can walk to another local
optimum.  The program searches in float32, the configuration's precision;
this reference in float64.  So a schedule is judged against two searches
on the same state and random bits: the plain float64 search
(``solver_ref.solve_round_np``) and the same search with every J₂ it ranks
rounded to float32.  (On CREMA-D seed 7447483701's third round the program
ends 0.0366·|J₂(∅)| above the float64 search, on the card and on the CPU
alike, at exactly the schedule that the float32-rounded search ends at;
PERF.md.)

``schedule_gap`` is (J₂(a) − the worse of the two searches' J₂) over
|J₂(nobody)|, at least 0, and +inf where ``a`` is infeasible; every J₂ it
compares is evaluated in float64.
"""
from __future__ import annotations

import numpy as np

from .solver_common import SolverHyper
from .solver_ref import allocate_np, bmin_np, objective_np, solve_round_np


def float32(J: np.ndarray) -> np.ndarray:
    """J rounded to float32, the precision the program searches in."""
    return J.astype(np.float32).astype(np.float64)


def objectives(data: dict, hp: SolverHyper, A) -> np.ndarray:
    """float64 J₂ of each schedule row of ``A`` under its KKT bandwidth;
    +inf where infeasible."""
    A = np.atleast_2d(np.asarray(A, bool))
    bmin, ok = bmin_np(data["gamma"], data["h"], data["tau_rem"],
                       data["B_max"], data["p_tx"], data["N0"], hp)
    B, feas = allocate_np(A, bmin, ok, data["Q"], data["gamma"], data["h"],
                          data["B_max"], data["p_tx"], data["N0"], hp)
    return objective_np(A, B, feas, data)


def searches(data: dict, seeds, draws, hp: SolverHyper) -> np.ndarray:
    """The schedules [2, K] of the float64 search and of the search that
    ranks float32-rounded J₂."""
    return np.stack([solve_round_np(data, seeds, draws, hp, round_J=r)[0]
                     for r in (None, float32)])


def schedule_gap(data: dict, seeds, draws, hp: SolverHyper, a) -> float:
    K = len(data["Q"])
    J = objectives(data, hp, np.concatenate(
        [np.zeros((1, K), bool), np.asarray(a, bool)[None],
         searches(data, seeds, draws, hp)]))
    if not np.isfinite(J[1]):
        return float("inf")
    return float(max(J[1] - np.max(J[2:]), 0.0) / abs(J[0]))
