"""Population-batched JCSBA solver (Algorithm 2 + P4.2' + Theorem 1).

* ``common``      — hyper-parameters, numerical conventions, round data (``build_solver_data``)
* ``torchsolver`` — float32 torch backend (``solver="jax"``), the population
  objective as a CUDA kernel on a card
* ``ref``         — float64 numpy mirror    (``solver="np"``)

The legacy scalar path (``wireless.bandwidth`` + ``wireless.immune``) stays
available as ``solver="seq"`` in ``schedulers.JCSBAScheduler``.
"""
from .common import SolverHyper, build_solver_data
from .ref import solve_round_np
from .torchsolver import make_draws, solve_core, solve_round

__all__ = ["SolverHyper", "build_solver_data", "make_draws", "solve_core",
           "solve_round", "solve_round_np"]
