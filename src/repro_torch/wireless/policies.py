"""Scheduling policies — every scheduler's per-round decision as one
function of tensors on the experiment's device.

The paper's evaluation (Figs. 4-6, Table 3) compares JCSBA against Random /
Round-Robin / Selection / Dropout baselines.  Each is a frozen
:class:`SchedulePolicy` (a value: equal configs compare equal) exposing

* ``init_state()`` — the policy's evolving state as a dict of numpy arrays
  (JCSBA: the warm-start antibody; Round-Robin: the cursor; the others:
  empty), checkpointed through the schedulers' ``state()/load_state()``;
* ``draws(generator, device)`` — the random bits one round consumes, as
  tensors (JCSBA: ``init``/``mut``/``fresh``; Random: ``u``; Dropout:
  ``perm``, ``u_drop``, ``u_which``; Round-Robin and Selection: none);
* ``step_full(state, data, model_dist, draws)`` — one round's decision
  ``(new_state, a, B, J, drop, cohort_idx)`` from the round context
  ``data`` (``solver.torchsolver.to_device``'s dict; the baselines read
  only ``B_max``), the ‖θ_k − θ⁰‖ bookkeeping and the draws.

The JAX package draws these bits from ``jax.random`` inside its traced
step.  Here they come in as tensors, made by a draw source from the round's
one host seed (``schedulers.PolicyScheduler``), so the tests can hand the
port the JAX package's own bits and hold it decision for decision.

``drop`` is a per-modality drop mask ``[M_drop, K]`` (zero rows for
policies without dropout); ``cohort_idx`` the static-size index vector of
the scheduled clients (ascending, padded with unscheduled indices).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .solver import SolverHyper
from .solver.torchsolver import make_draws, solve_core

POLICY_NAMES = ("jcsba", "random", "round_robin", "selection", "dropout")


def cohort_indices(a, cohort_size: int):
    """Static-size cohort index vector from a dense schedule mask: the
    scheduled clients in ascending index order, then unscheduled padding
    (also ascending) — ``torch.topk`` over the unique keys
    ``(a ? 3K : K) − k``, as the JAX package's ``lax.top_k``."""
    a = torch.as_tensor(a).to(torch.bool)
    K = a.shape[0]
    key = (torch.where(a, 3 * K, K)
           - torch.arange(K, device=a.device))
    return torch.topk(key, cohort_size).indices.to(torch.int32)


def equal_bandwidth_traced(a, B_max):
    """The baselines' equal split: B_max/n over scheduled clients, exact
    zeros elsewhere (and everywhere when nobody is scheduled)."""
    n = a.sum()
    share = torch.full((), B_max, dtype=torch.float32,
                       device=a.device) / torch.clamp_min(n, 1)
    return torch.where(a, share, 0.0)


def _mask(K: int, idx, device):
    return torch.zeros(K, dtype=torch.bool, device=device).index_fill_(
        0, idx.to(torch.long), True)


def _nan(device):
    return torch.full((), float("nan"), dtype=torch.float32, device=device)


class SchedulePolicy:
    """Protocol for per-round scheduling decisions.  Implementations are
    frozen dataclasses; all evolving state flows through ``state``."""
    name = "base"
    #: modality names addressing ``step_full``'s drop-mask rows (empty for
    #: policies without dropout)
    drop_mods: Tuple[str, ...] = ()

    @property
    def cohort_size(self) -> int:
        """Upper bound on how many clients the policy schedules in one
        round — the length of the cohort index vector (default K)."""
        return self.K

    def init_state(self) -> Dict[str, np.ndarray]:
        return {}

    def draws(self, generator: torch.Generator, device) -> dict:
        """The random bits one round of this policy consumes."""
        return {}

    def step_full(self, state, data, model_dist, draws):
        """``-> (new_state, a [K] bool, B [K] f32, J 0-d f32, drop [M_drop,
        K] bool, cohort_idx [cohort_size] int32)``."""
        raise NotImplementedError

    def step(self, state, data, model_dist, draws):
        """The classic 4-tuple projection of ``step_full``."""
        return self.step_full(state, data, model_dist, draws)[:4]

    def _finish(self, state, a, B, J, drop=None):
        if drop is None:
            drop = torch.zeros((0, a.shape[0]), dtype=torch.bool,
                               device=a.device)
        return state, a, B, J, drop, cohort_indices(a, self.cohort_size)


@dataclasses.dataclass(frozen=True)
class JCSBAPolicy(SchedulePolicy):
    """The paper's joint scheduling + bandwidth algorithm (Algorithm 2 +
    P4.2' + Theorem-1 bound) via the population-batched solver.  State is
    the warm-start antibody: the previous round's winner is written over
    population row 0, the all-zeros antibody over row 1."""
    K: int
    hp: SolverHyper = SolverHyper()
    max_cohort: Optional[int] = None
    name = "jcsba"

    @property
    def cohort_size(self) -> int:
        return self.K if self.max_cohort is None \
            else min(self.max_cohort, self.K)

    def init_state(self):
        return {"warm_a": np.zeros(self.K, bool)}

    def draws(self, generator, device):
        init, mut, fresh = make_draws(generator, self.K, self.hp, device)
        return {"init": init, "mut": mut, "fresh": fresh}

    def step_full(self, state, data, model_dist, draws):
        warm = torch.as_tensor(state["warm_a"]).to(torch.bool)
        seeds = torch.stack([warm, torch.zeros_like(warm)])
        a, J, B = solve_core(data, seeds, (draws["init"], draws["mut"],
                                           draws["fresh"]), self.hp)
        return self._finish({"warm_a": a}, a, B, J)


@dataclasses.dataclass(frozen=True)
class RandomPolicy(SchedulePolicy):
    """Random client subset (without replacement), equal bandwidth split:
    the ``n_sched`` largest of K iid uniforms."""
    K: int
    n_sched: int = 4
    name = "random"

    @property
    def cohort_size(self) -> int:
        return min(self.n_sched, self.K)

    def draws(self, generator, device):
        return {"u": torch.rand(self.K, generator=generator, device=device)}

    def step_full(self, state, data, model_dist, draws):
        u = torch.as_tensor(draws["u"])
        a = _mask(self.K, torch.topk(u, min(self.n_sched, self.K)).indices,
                  u.device)
        return self._finish(state, a,
                            equal_bandwidth_traced(a, data["B_max"]),
                            _nan(u.device))


@dataclasses.dataclass(frozen=True)
class RoundRobinPolicy(SchedulePolicy):
    """Cycle through clients in fixed order, equal bandwidth.  State is the
    cursor (int32)."""
    K: int
    n_sched: int = 4
    name = "round_robin"

    @property
    def cohort_size(self) -> int:
        return min(self.n_sched, self.K)

    def init_state(self):
        return {"next": np.zeros((), np.int32)}

    def step_full(self, state, data, model_dist, draws):
        device = model_dist.device
        nxt = torch.as_tensor(state["next"], device=device).to(torch.int32)
        n = min(self.n_sched, self.K)
        idx = (nxt + torch.arange(n, dtype=torch.int32, device=device)) \
            % self.K
        a = _mask(self.K, idx, device)
        new = {"next": (nxt + self.n_sched) % self.K}
        return self._finish(new, a,
                            equal_bandwidth_traced(a, data["B_max"]),
                            _nan(device))


@dataclasses.dataclass(frozen=True)
class SelectionPolicy(SchedulePolicy):
    """[26]: fixed selection ratio per modality-combination group; within
    each group pick the clients whose local model moved farthest from θ⁰
    (a stable sort, so ties go to the lowest client index).

    ``group_ids[k]`` is client k's group, ``group_picks`` holds ``(group,
    n_pick)`` with ``n_pick = max(1, round(ratio·|group|))``."""
    K: int
    group_ids: Tuple[int, ...]
    group_picks: Tuple[Tuple[int, int], ...]
    name = "selection"

    @classmethod
    def from_modalities(cls, K: int,
                        client_modalities: Optional[Sequence[Sequence[str]]],
                        ratio: float = 0.4) -> "SelectionPolicy":
        mods = client_modalities or [("m",)] * K
        gid_of: Dict[frozenset, int] = {}
        gids = [gid_of.setdefault(frozenset(m), len(gid_of)) for m in mods]
        sizes: Dict[int, int] = {}
        for g in gids:
            sizes[g] = sizes.get(g, 0) + 1
        picks = tuple(sorted((g, max(1, int(round(ratio * n))))
                             for g, n in sizes.items()))
        return cls(K, tuple(gids), picks)

    @property
    def cohort_size(self) -> int:
        return min(self.K, sum(n for _, n in self.group_picks))

    def step_full(self, state, data, model_dist, draws):
        dist = torch.as_tensor(model_dist).to(torch.float32)
        gid = torch.tensor(self.group_ids, dtype=torch.int32,
                           device=dist.device)
        a = torch.zeros(self.K, dtype=torch.bool, device=dist.device)
        for g, n_pick in self.group_picks:
            scores = torch.where(gid == g, dist, -float("inf"))
            top = torch.argsort(-scores, stable=True)[:n_pick]
            a = a.index_fill(0, top, True)
        return self._finish(state, a,
                            equal_bandwidth_traced(a, data["B_max"]),
                            _nan(dist.device))


@dataclasses.dataclass(frozen=True)
class DropoutPolicy(SchedulePolicy):
    """[28]: random scheduling + modality dropout — scheduled multimodal
    clients drop one uniformly-chosen owned modality with probability
    ``p_drop`` (unimodal clients never drop).  ``step_full`` emits a
    ``[M, K]`` drop mask whose rows follow ``drop_mods`` (the cohort's
    modality names, sorted); ``owns[i][k]`` ⇔ client k owns
    ``drop_mods[i]``.  Draws: a permutation of the clients for the subset,
    and a drop-the-coin and a which-modality uniform per client."""
    K: int
    drop_mods: Tuple[str, ...] = ()
    owns: Tuple[Tuple[bool, ...], ...] = ()  # [M][K], static
    n_sched: int = 4
    p_drop: float = 0.3
    name = "dropout"

    @classmethod
    def from_modalities(cls, K: int,
                        client_modalities: Optional[Sequence[Sequence[str]]],
                        n_sched: int = 4, p_drop: float = 0.3
                        ) -> "DropoutPolicy":
        mods = client_modalities or [("m",)] * K
        names = tuple(sorted({m for ms in mods for m in ms}))
        owns = tuple(tuple(m in ms for ms in mods) for m in names)
        return cls(K, names, owns, n_sched, float(p_drop))

    @property
    def cohort_size(self) -> int:
        return min(self.n_sched, self.K)

    def draws(self, generator, device):
        return {"perm": torch.randperm(self.K, generator=generator,
                                       device=device),
                "u_drop": torch.rand(self.K, generator=generator,
                                     device=device),
                "u_which": torch.rand(self.K, generator=generator,
                                      device=device)}

    def drop_mask(self, a, u_drop, u_which):
        """[M, K] bool — modality ``drop_mods[i]`` dropped by client k."""
        owns = torch.tensor(self.owns, dtype=torch.bool,
                            device=a.device).reshape(len(self.drop_mods),
                                                     self.K)
        n_owned = owns.sum(0)                                # [K]
        do = a & (n_owned > 1) & (u_drop < self.p_drop)
        # uniform pick among the client's owned modalities, in row order:
        # rank[i, k] = #owned rows above i; the pick is the rank-th owned row
        which = torch.minimum((u_which * n_owned).to(torch.int32),
                              torch.clamp_min(n_owned - 1, 0))
        rank = torch.cumsum(owns, 0) - owns.to(torch.long)
        return do[None] & owns & (rank == which[None])

    def step_full(self, state, data, model_dist, draws):
        perm = torch.as_tensor(draws["perm"])
        n = min(self.n_sched, self.K)
        a = _mask(self.K, perm[:n], perm.device)
        drop = self.drop_mask(a, torch.as_tensor(draws["u_drop"]),
                              torch.as_tensor(draws["u_which"]))
        return self._finish(state, a,
                            equal_bandwidth_traced(a, data["B_max"]),
                            _nan(perm.device), drop)


def policy_step(policy: SchedulePolicy, state, data, model_dist, draws):
    """``policy.step_full`` — the canonical 6-tuple ``(state, a, B, J,
    drop, cohort_idx)`` from the round's draws (the JAX package's
    ``policy_step`` takes the seed and draws inside)."""
    return policy.step_full(state, data, model_dist, draws)


def make_policy(name: str, K: int,
                client_modalities: Optional[Sequence[Sequence[str]]] = None,
                **kw) -> SchedulePolicy:
    name = name.lower()
    if name == "jcsba":
        return JCSBAPolicy(K, SolverHyper(**kw.get("immune_kwargs", {}) or {}),
                           kw.get("max_cohort"))
    if name == "random":
        return RandomPolicy(K, kw.get("n_sched", 4))
    if name in ("round_robin", "roundrobin"):
        return RoundRobinPolicy(K, kw.get("n_sched", 4))
    if name == "selection":
        return SelectionPolicy.from_modalities(K, client_modalities,
                                               kw.get("ratio", 0.4))
    if name == "dropout":
        return DropoutPolicy.from_modalities(K, client_modalities,
                                             kw.get("n_sched", 4),
                                             kw.get("p_drop", 0.3))
    raise ValueError(f"no policy named {name!r}")
