"""Client scheduling strategies — thin host wrappers over the policies.

* ``JCSBAScheduler`` — the paper's algorithm: per-round P3 objective
  J₂(a) = V·ηρ√(A₁+A₂) + Σ_k a_k Q_k (e_com_k(B*) + e_cmp_k)
  (the −Σ Q_k E_add constant is dropped, §V-A), inner bandwidth by the KKT
  solver, outer search by the immune algorithm.
* Baselines from §VI: Random, Round-Robin (equal bandwidth), Selection [26]
  (fixed ratios per modality-combination, picked by model distance), and
  Dropout [28] (random scheduling + modality dropout on multimodal clients —
  the dropout itself is applied by the FL runtime, flagged here).

Every policy's decision lives in ``wireless.policies`` as a
``SchedulePolicy.step_full`` on tensors; the ``Scheduler`` classes here
manage host state (rng stream, policy state, ScheduleContext → device
conversion) and read the decision back in one copy a round.

RNG discipline, as in the JAX package: every policy-backed scheduler, and
JCSBA's ``np`` backend, consumes exactly ONE ``rng.integers(2**31)`` host
draw per round, scheduled or not, feasible or not.  That draw seeds the
round's draw source — by default a ``torch.Generator`` on the experiment's
device, ``manual_seed(seed)``, handed to ``policy.draws`` — so the numpy
stream (channel draws, client seeds) stays in step with the JAX package's.
A scheduler takes an optional ``draw_source(policy, seed) -> draws``
instead; the tests pass one that builds the JAX package's ``jax.random``
bits from the same seed, so the port's decisions equal the JAX package's.
JCSBA's ``seq`` backend draws from the numpy stream itself, as there.

Policy state (JCSBA's warm-start antibody, Round-Robin's cursor) is exposed
through ``state()/load_state()`` — the checkpointing API.

All schedulers return ``ScheduleDecision`` with the participation vector, the
bandwidth allocation and per-client modality-dropout flags.  Clients whose
latency constraint ends up violated (possible under the naive equal-bandwidth
baselines) are marked as transmission failures by the runtime.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.convergence import BoundState
from ..device import resolve_device
from .bandwidth import allocate
from .cost import ClientCost, com_energy, com_latency
from .params import WirelessParams

#: ``draw_source(policy, seed) -> draws``: the random bits of one round
DrawSource = Callable[[object, int], dict]


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
    dropout_modality: Optional[List[Optional[str]]] = None
    objective: float = np.nan


class Scheduler:
    name = "base"
    policy = None           # the policy, when one exists (PolicyScheduler)

    def bind(self, K: int,
             client_modalities: Optional[Sequence] = None) -> None:
        """Bind the scheduler to a cohort size (no-op for host-only
        schedulers); the runtime calls it at experiment init."""

    def state(self) -> Dict[str, np.ndarray]:
        """Checkpointable policy state (empty for stateless schedulers)."""
        return {}

    def load_state(self, state: Dict[str, np.ndarray]) -> None:
        """Restore ``state()``'s dict (no-op for stateless schedulers)."""

    def schedule(self, ctx: ScheduleContext) -> ScheduleDecision:  # pragma: no cover
        raise NotImplementedError


class PolicyScheduler(Scheduler):
    """Host wrapper over a ``wireless.policies.SchedulePolicy``.

    Subclasses implement ``_make_policy(K, client_modalities)`` and, when
    the policy needs more context than ``B_max`` (JCSBA), ``_build_data``.
    ``schedule`` draws the round's seed, makes its bits with the draw
    source, runs ``policies.policy_step`` on ``device`` and keeps the policy state as
    host numpy between rounds."""

    def __init__(self, rng: np.random.Generator, device="cuda",
                 draw_source: Optional[DrawSource] = None):
        self.rng = rng
        self.device = resolve_device(device)
        self.draw_source = draw_source
        self._policy = None
        self._state: Optional[Dict[str, np.ndarray]] = None
        self._K: Optional[int] = None

    # -- policy lifecycle ---------------------------------------------------
    def _make_policy(self, K: int, client_modalities):
        raise NotImplementedError

    def bind(self, K: int, client_modalities=None) -> None:
        self._K = K
        pol = self._make_policy(K, client_modalities)
        if pol is None:                     # host-only backend (jcsba np/seq)
            self._policy = None
            return
        # policies are frozen dataclasses, so value equality detects any
        # config change; an unchanged policy keeps its state across rebinds
        if pol != self._policy:
            self._policy = pol
            self._state = pol.init_state()

    @property
    def policy(self):
        return self._policy

    # -- checkpoint API -------------------------------------------------------
    def state(self) -> Dict[str, np.ndarray]:
        return {} if self._state is None else \
            {k: np.asarray(v) for k, v in self._state.items()}

    def load_state(self, state: Dict[str, np.ndarray]) -> None:
        if self._state is None:
            self._state = {}
        for k, tmpl in list(self._state.items()):
            if k in state:
                self._state[k] = np.asarray(state[k], tmpl.dtype)

    # -- the per-round drive -----------------------------------------------
    def _draws(self, policy, seed: int) -> dict:
        """The round's bits: the draw source's, or ``policy.draws`` from a
        generator on ``device`` seeded with ``seed``."""
        if self.draw_source is not None:
            return self.draw_source(policy, seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return policy.draws(gen, self.device)

    def round_draws(self, seed: int) -> dict:
        """The bits of the round seeded with ``seed``, as tensors on
        ``device`` (the fused round draws them up front,
        ``fl.fused_round.draw_round_xs``)."""
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self._draws(self._policy, seed).items()}

    def _build_data(self, ctx: ScheduleContext) -> dict:
        return {"B_max": float(np.float32(ctx.params.B_max))}

    def schedule(self, ctx: ScheduleContext) -> ScheduleDecision:
        from .policies import policy_step
        K = len(ctx.h)
        self.bind(K, ctx.client_modalities)
        seed = int(self.rng.integers(2 ** 31))
        dev = self.device
        draws = self.round_draws(seed)
        dist = torch.as_tensor(np.zeros(K) if ctx.model_dist is None
                               else ctx.model_dist, dtype=torch.float32,
                               device=dev)
        state = {k: torch.as_tensor(v, device=dev)
                 for k, v in self._state.items()}
        state, a, B, J, drop, _ = policy_step(
            self._policy, state, self._build_data(ctx), dist, draws)
        # one device-to-host copy of everything the host keeps
        parts = [a, B, J.reshape(1), drop.reshape(-1),
                 *(v.reshape(-1) for v in state.values())]
        host = torch.cat([p.to(torch.float64) for p in parts]).cpu().numpy()
        sizes = np.cumsum([p.numel() for p in parts])[:-1]
        a, B, J, drop, *vals = np.split(host, sizes)
        self._state = {k: vals[i].reshape(self._state[k].shape)
                       .astype(self._state[k].dtype)
                       for i, k in enumerate(state)}
        drops: Optional[List[Optional[str]]] = None
        drop = drop.reshape(-1, K) > 0.5
        if drop.shape[0]:
            drops = [None] * K
            for i, m in enumerate(self._policy.drop_mods):
                for k in np.flatnonzero(drop[i]):
                    drops[k] = m
        return ScheduleDecision(a > 0.5, B, dropout_modality=drops,
                                objective=float(J[0]))


class RandomScheduler(PolicyScheduler):
    """Random client subset, equal bandwidth split."""
    name = "random"

    def __init__(self, rng: np.random.Generator, n_sched: int = 4, **kw):
        super().__init__(rng, **kw)
        self.n_sched = n_sched

    def _make_policy(self, K, client_modalities):
        from .policies import make_policy
        return make_policy(self.name, K, n_sched=self.n_sched)


class RoundRobinScheduler(PolicyScheduler):
    """Cycle through clients in fixed order, equal bandwidth."""
    name = "round_robin"

    def __init__(self, rng: np.random.Generator, n_sched: int = 4, **kw):
        super().__init__(rng, **kw)
        self.n_sched = n_sched

    def _make_policy(self, K, client_modalities):
        from .policies import make_policy
        return make_policy(self.name, K, n_sched=self.n_sched)


class SelectionScheduler(PolicyScheduler):
    """[26]: fixed selection ratio per modality-combination group; within
    each group pick the clients whose local model moved farthest from θ⁰."""
    name = "selection"

    def __init__(self, rng: np.random.Generator, ratio: float = 0.4, **kw):
        super().__init__(rng, **kw)
        self.ratio = ratio

    def _make_policy(self, K, client_modalities):
        from .policies import make_policy
        return make_policy(self.name, K, client_modalities,
                           ratio=self.ratio)


class DropoutScheduler(PolicyScheduler):
    """[28]: random scheduling; multimodal clients drop one modality w.p.
    ``p_drop`` (the drop bits are part of the policy's draws)."""
    name = "dropout"

    def __init__(self, rng: np.random.Generator, n_sched: int = 4,
                 p_drop: float = 0.3, **kw):
        super().__init__(rng, **kw)
        self.n_sched = n_sched
        self.p_drop = p_drop

    def _make_policy(self, K, client_modalities):
        from .policies import make_policy
        return make_policy(self.name, K, client_modalities,
                           n_sched=self.n_sched, p_drop=self.p_drop)


class JCSBAScheduler(PolicyScheduler):
    """The paper's joint client-scheduling + bandwidth-allocation algorithm.

    Three interchangeable solver backends (``solver=``), as in the JAX
    package:

    * ``"jax"`` (default) — ``policies.JCSBAPolicy`` over the
      population-batched torch solver (``wireless.solver.torchsolver``) on
      ``device``, the population objective a CUDA kernel on a card (the
      name is the JAX package's, for its traced solver);
    * ``"np"`` — the float64 numpy mirror (``wireless.solver.ref``), same
      algorithm on the same random bits (the draw source's, moved to the
      host);
    * ``"seq"`` — the original sequential memoised path (scalar
      ``bandwidth.allocate`` inside ``immune.immune_search``), drawing from
      the numpy stream itself.

    Warm-start seeding is explicit for every backend: the previous round's
    winner (when one exists) and the all-zeros antibody are written over
    the first population rows, so an empty schedule is always evaluated
    and the returned objective is always finite.  For ``solver="jax"`` the
    warm start IS the policy state (``state()["warm_a"]``); the np/seq
    backends keep it in ``_last_a`` (an all-zeros warm row is
    indistinguishable from "no winner yet" after seed padding, so the two
    representations round-trip exactly through ``state()/load_state()``).
    """
    name = "jcsba"

    def __init__(self, rng: np.random.Generator, V: float = 1.0,
                 immune_kwargs: Optional[dict] = None, solver: str = "jax",
                 **kw):
        if solver not in ("jax", "np", "seq"):
            raise ValueError(f"unknown JCSBA solver backend {solver!r}")
        super().__init__(rng, **kw)
        self.V = V
        self.immune_kwargs = immune_kwargs or {}
        self.solver = solver
        self._last_a: Optional[np.ndarray] = None    # np/seq warm start

    def _make_policy(self, K, client_modalities):
        if self.solver != "jax":
            return None
        from .policies import make_policy
        return make_policy(self.name, K, immune_kwargs=self.immune_kwargs)

    def _solver_data(self, ctx: ScheduleContext) -> dict:
        from .solver import build_solver_data
        return build_solver_data(ctx.h, ctx.Q, ctx.cost, ctx.params,
                                 ctx.bound, self.V)

    def _build_data(self, ctx: ScheduleContext) -> dict:
        from .solver.torchsolver import to_device
        return to_device(self._solver_data(ctx), self.device)

    # -- checkpoint API covers all three backends ------------------------
    def state(self) -> Dict[str, np.ndarray]:
        if self.solver == "jax" and self._state is not None:
            return {k: np.asarray(v) for k, v in self._state.items()}
        K = self._K if self._K is not None else (
            len(self._last_a) if self._last_a is not None else 0)
        warm = (np.zeros(K, bool) if self._last_a is None
                else np.asarray(self._last_a, bool))
        return {"warm_a": warm}

    def load_state(self, state: Dict[str, np.ndarray]) -> None:
        if "warm_a" not in state:
            return
        warm = np.asarray(state["warm_a"], bool)
        if self.solver == "jax":
            self.bind(len(warm))
            self._state = {"warm_a": warm}
        else:
            self._last_a = warm

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
        """Warm-start rows: last round's winner (when one exists) followed
        by the all-zeros antibody.  1 row on round 0, 2 afterwards (the
        batched backends pad to their fixed [2, K] shape)."""
        rows = [] if self._last_a is None else [np.asarray(self._last_a, bool)]
        rows.append(np.zeros(K, bool))
        return np.stack(rows)

    def _schedule_seq(self, ctx: ScheduleContext) -> ScheduleDecision:
        """Original sequential path: scalar KKT solve per memoised
        antibody."""
        from .immune import immune_search
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

    def _schedule_np(self, ctx: ScheduleContext) -> ScheduleDecision:
        """Float64 numpy mirror on the round's draws."""
        from .policies import JCSBAPolicy
        from .solver import SolverHyper, solve_round_np
        K = len(ctx.h)
        hp = SolverHyper(**self.immune_kwargs)
        seeds = self._seed_antibodies(K)
        if len(seeds) < 2:      # fixed [2, K] shape matches the jax backend
            seeds = np.vstack([seeds, np.zeros((2 - len(seeds), K), bool)])
        draws = self._draws(JCSBAPolicy(K, hp),
                            int(self.rng.integers(2 ** 31)))
        bits = [np.asarray(torch.as_tensor(draws[k]).cpu(), bool)
                for k in ("init", "mut", "fresh")]
        a_star, J_star, B = solve_round_np(self._solver_data(ctx), seeds,
                                           bits, hp)
        a_star = np.asarray(a_star, bool)
        self._last_a = a_star.copy()
        return ScheduleDecision(a_star, np.asarray(B, float),
                                objective=float(J_star))

    def schedule(self, ctx: ScheduleContext) -> ScheduleDecision:
        self.bind(len(ctx.h), ctx.client_modalities)
        if self.solver == "seq":
            return self._schedule_seq(ctx)
        if self.solver == "np":
            return self._schedule_np(ctx)
        return super().schedule(ctx)


def make_scheduler(name: str, rng: np.random.Generator, **kw) -> Scheduler:
    """The scheduler ``name`` on ``device`` (keyword; default ``"cuda"``),
    with an optional ``draw_source``."""
    name = name.lower()
    if name == "random":
        return RandomScheduler(rng, **kw)
    if name in ("round_robin", "roundrobin"):
        return RoundRobinScheduler(rng, **kw)
    if name == "selection":
        return SelectionScheduler(rng, **kw)
    if name == "dropout":
        return DropoutScheduler(rng, **kw)
    if name == "jcsba":
        return JCSBAScheduler(rng, **kw)
    raise ValueError(f"unknown scheduler {name!r}")
