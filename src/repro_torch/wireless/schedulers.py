"""Client scheduling — the paper's JCSBA on the host.

``JCSBAScheduler`` minimises the per-round P3 objective
J₂(a) = V·ηρ√(A₁+A₂) + Σ_k a_k Q_k (e_com_k(B*) + e_cmp_k)
(the −Σ Q_k E_add constant is dropped, §V-A): inner bandwidth by the KKT
solver (``bandwidth.allocate``), outer search by the immune algorithm
(``immune.immune_search``).  This slice of the port carries the JAX
package's ``solver="seq"`` backend only: it runs on the host in numpy and
draws only from the experiment's ``Generator``, so the port schedules
exactly as the JAX package does on the same seed.

The traced solver backends (``"jax"``, ``"np"``) and the four baseline
policies (random, round_robin, selection, dropout) draw ``jax.random`` bits
in the JAX package; they are ROADMAP Queue 1 item 5 and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..core.convergence import BoundState
from .bandwidth import allocate
from .cost import ClientCost, com_energy, com_latency
from .immune import immune_search
from .params import WirelessParams

#: where the unported scheduling pieces are queued
_QUEUED = ("ROADMAP.md Queue 1 item 5 (traced solver backends and "
           "policies, driven by random bits passed in)")


@dataclasses.dataclass
class ScheduleContext:
    h: np.ndarray                       # channel gains this round
    Q: np.ndarray                       # Lyapunov queues
    cost: ClientCost
    params: WirelessParams
    bound: Optional[BoundState]
    round_idx: int
    model_dist: Optional[np.ndarray] = None   # ||θ_k − θ⁰|| for Selection
    client_modalities: Optional[Sequence[Sequence[str]]] = None


@dataclasses.dataclass
class ScheduleDecision:
    a: np.ndarray                       # bool [K]
    B: np.ndarray                       # [K] Hz
    objective: float = np.nan


class Scheduler:
    name = "base"

    def schedule(self, ctx: ScheduleContext) -> ScheduleDecision:  # pragma: no cover
        raise NotImplementedError


class JCSBAScheduler(Scheduler):
    """The paper's joint client-scheduling + bandwidth-allocation algorithm,
    on the sequential memoised path (scalar ``allocate`` inside
    ``immune_search``).  The previous round's winner and the all-zeros
    antibody seed the population, so an empty schedule is always evaluated
    and the returned objective is always finite."""
    name = "jcsba"

    def __init__(self, rng: np.random.Generator, V: float = 1.0,
                 immune_kwargs: Optional[dict] = None, solver: str = "seq"):
        if solver in ("jax", "np"):
            raise NotImplementedError(
                f"JCSBA solver backend {solver!r} is not ported yet; it is "
                f"{_QUEUED}. Use solver='seq' (engine '<loop>:seq').")
        if solver != "seq":
            raise ValueError(f"unknown JCSBA solver backend {solver!r}")
        self.rng = rng
        self.V = V
        self.immune_kwargs = immune_kwargs or {}
        self._last_a: Optional[np.ndarray] = None    # warm start

    # -- inner: bandwidth for a candidate a; returns (B, J2) or (None, inf) --
    def _evaluate(self, a: np.ndarray, ctx: ScheduleContext):
        K = len(ctx.h)
        part = np.flatnonzero(a)
        bound_term = (ctx.bound.objective(a.astype(float))
                      if ctx.bound is not None else 0.0)
        if len(part) == 0:
            return np.zeros(K), self.V * bound_term
        tau_rem = ctx.cost.tau_residual(ctx.params)[part]
        Bp = allocate(ctx.Q[part], ctx.cost.gamma_bits[part], ctx.h[part],
                      tau_rem, ctx.params)
        if Bp is None:
            return None, np.inf
        B = np.zeros(K)
        B[part] = Bp
        tcom = com_latency(B[part], ctx.h[part], ctx.cost.gamma_bits[part],
                           ctx.params)
        ecom = com_energy(tcom, ctx.params)
        J2 = (self.V * bound_term
              + float((ctx.Q[part] * (ecom + ctx.cost.e_cmp[part])).sum()))
        return B, J2

    def _seed_antibodies(self, K: int) -> np.ndarray:
        """Warm-start rows: last round's winner (when one exists) followed by
        the all-zeros antibody."""
        rows = [] if self._last_a is None else [np.asarray(self._last_a, bool)]
        rows.append(np.zeros(K, bool))
        return np.stack(rows)

    def schedule(self, ctx: ScheduleContext) -> ScheduleDecision:
        K = len(ctx.h)

        def eval_fn(a):
            _, J = self._evaluate(np.asarray(a, bool), ctx)
            return J

        a_star, J_star = immune_search(
            eval_fn, K, self.rng, seed_antibodies=self._seed_antibodies(K),
            **self.immune_kwargs)
        B, _ = self._evaluate(a_star, ctx)
        if B is None:                                   # paranoid fallback
            a_star = np.zeros(K, bool)
            B = np.zeros(K)
        self._last_a = a_star.copy()
        return ScheduleDecision(a_star, B, objective=J_star)


def make_scheduler(name: str, rng: np.random.Generator, **kw) -> Scheduler:
    name = name.lower()
    if name == "jcsba":
        return JCSBAScheduler(rng, **kw)
    if name in ("random", "round_robin", "roundrobin", "selection",
                "dropout"):
        raise NotImplementedError(
            f"scheduler {name!r} is not ported yet; it is {_QUEUED}")
    raise ValueError(f"unknown scheduler {name!r}")
