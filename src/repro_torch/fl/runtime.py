"""The wireless MFL loop — Algorithm 1 of the paper.

Per communication round t:
  1. redraw channel gains h_k;
  2. the server schedules clients and allocates bandwidth by JCSBA (the
     host immune search of ``wireless.schedulers``);
  3. scheduled clients run the local update (one BGD epoch, Eq. 7) — clients
     whose latency constraint is violated under the chosen bandwidth are
     *transmission failures*: they consume energy but contribute no update;
  4. per-modality aggregation with participated weights (Eq. 12);
  5. Lyapunov queues and the Theorem-1 ζ/δ trackers are updated;
  6. test metrics (multimodal + per-modality accuracy) are recorded.

Step 3 runs all K clients' updates as one cohort step over a dense,
device-resident client stack (``data.partition.StackedClients``): every
modality is materialised for every client at a fixed ``max_batch``, padding
is masked out of the loss by a ``sample_mask``, and a per-modality 0/1
upload mask [K] (scheduled ∧ no transmission failure ∧ owns the modality)
zeroes the loss — hence the gradient — of everything that is not uploaded.
Unscheduled clients still run in the stack with avail = 0.

The engine spec keeps the JAX package's grammar,
``"<loop>[:<token>[+<token>...]]"``.  The port runs the ``batched`` loop
with the ``seq`` JCSBA solver; the ``pallas`` token selects the CUDA
fusion-loss kernel and, for the transformer/SSD backbones (``arch=``), the
flash-attention / SSD kernels in their mixers; ``remat`` checkpoints the
cohort forward.  The default is ``"batched:seq+pallas"``.  The run
consumes the experiment's numpy ``Generator`` in the JAX package's order —
channel draw, K client seeds, immune search — so participants match the
JAX package round by round.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import aggregation as agg
from ..core.convergence import BoundState
from ..core.trees import tree_map
from ..data import synthetic
from ..data.partition import partition, stack_clients, train_test_split
from ..device import resolve_device
from ..wireless import cost as wcost
from ..wireless.channel import Channel
from ..wireless.lyapunov import EnergyQueues
from ..wireless.params import MODALITY_PROFILES, WirelessParams
from ..wireless.schedulers import ScheduleContext, Scheduler, make_scheduler
from .client import make_adapter


@dataclasses.dataclass
class RoundRecord:
    round: int
    participants: List[int]
    failures: List[int]
    energy_total: float
    metrics: Dict[str, float]
    sched_time_s: float

    @classmethod
    def make(cls, round, participants, failures, energy_total, metrics,
             sched_time_s) -> "RoundRecord":
        """Normalises every field to plain Python, so records are JSON-safe."""
        return cls(int(round), [int(v) for v in participants],
                   [int(v) for v in failures], float(energy_total),
                   {k: float(v) for k, v in metrics.items()},
                   float(sched_time_s))


#: valid ``engine=`` loop names, in increasing fusion order
ENGINE_LOOPS = ("seq", "batched", "fused")

#: valid "+"-joined engine-spec tokens after the ":"
ENGINE_TOKENS = ("jax", "np", "seq", "pallas", "remat")

#: the loops the port does not run yet, and where they are queued
_QUEUED = {"seq": "ROADMAP.md Queue 1 item 6 (the seq loop)",
           "fused": "ROADMAP.md Queue 1 item 7 (fused_round.py)"}


def parse_engine(engine: str):
    """``"<loop>[:<token>[+<token>...]]"`` → (loop, solver_backend,
    loss_backend, remat, use_kernels, canonical spec), as in the JAX
    package."""
    loop, _, rest = engine.partition(":")
    if loop not in ENGINE_LOOPS:
        raise ValueError(
            f"unknown engine {engine!r}; expected 'seq' | 'batched' | "
            f"'fused' with an optional ':<token>[+<token>...]' suffix from "
            f"{ENGINE_TOKENS}")
    tokens = [t for t in rest.split("+") if t] if rest else []
    for t in tokens:
        if t not in ENGINE_TOKENS:
            raise ValueError(
                f"unknown engine token {t!r} in {engine!r}; "
                f"choose from {ENGINE_TOKENS}")
    solver = [t for t in tokens if t in ("np", "seq")]
    if len(solver) > 1:
        raise ValueError(f"conflicting solver backends in {engine!r}")
    solver_backend = solver[0] if solver else "jax"
    loss_backend = "pallas" if "pallas" in tokens else "xla"
    remat = "remat" in tokens
    canon = loop + (":" + "+".join(tokens) if tokens else ":jax")
    return loop, solver_backend, loss_backend, remat, "pallas" in tokens, canon


class MFLExperiment:
    """Algorithm 1 end to end on ``device`` (default ``"cuda"``; raises
    without a card unless ``device="cpu"``)."""

    def __init__(self, dataset: str = "crema_d", scheduler: str = "jcsba",
                 K: int = 10, omega: float = 0.3, n_samples: int = 1200,
                 dirichlet_alpha: float = 0.0,
                 eta: float = 0.05, V: float = 1.0, seed: int = 0,
                 params: Optional[WirelessParams] = None,
                 scheduler_kwargs: Optional[dict] = None,
                 eval_every: int = 1, engine: str = "batched:seq+pallas",
                 arch: str = "lstm-cnn", device="cuda"):
        self.device = resolve_device(device)
        (loop, solver_backend, loss_backend, remat, use_kernels,
         self.engine) = parse_engine(engine)
        if loop in _QUEUED:
            raise NotImplementedError(
                f"engine {engine!r}: {loop!r} is not ported yet; it is "
                f"{_QUEUED[loop]}")
        self.rng = np.random.default_rng(seed)
        self.params = params or WirelessParams(K=K)
        self.eval_every = eval_every
        self._stacked_dev = None            # device-resident client stack
        self._stacked_src = None            # cohort it was built from

        full = synthetic.DATASETS[dataset](seed=seed, n=n_samples)
        self.train_ds, self.test_ds = train_test_split(full, 0.2, seed)
        self.clients = partition(self.train_ds, K, omega, seed,
                                 dirichlet_alpha=dirichlet_alpha)
        self.all_mods = sorted(full.features.keys())
        self.client_mods = [c.modalities for c in self.clients]
        self.data_sizes = [c.size for c in self.clients]
        self.profile = MODALITY_PROFILES[dataset]

        self.adapter = make_adapter(dataset, arch, eta=eta,
                                    loss_backend=loss_backend, remat=remat,
                                    use_kernels=use_kernels)
        self.global_params = self.adapter.init_global(
            torch.Generator().manual_seed(seed), self.device)
        self.init_params = tree_map(torch.clone, self.global_params)

        self.cost = wcost.client_costs(self.data_sizes, self.client_mods,
                                       self.profile, self.params)
        self.channel = Channel(self.params, self.rng)
        self.queues = EnergyQueues(K)
        w_bar = agg.unified_weights(self.data_sizes, self.client_mods,
                                    self.all_mods)
        self.bound = BoundState(K, self.all_mods, self.client_mods, w_bar,
                                self.data_sizes, eta=eta)
        kw = dict(scheduler_kwargs or {})
        if scheduler == "jcsba":
            kw.setdefault("V", V)
            kw.setdefault("solver", solver_backend)
        self.scheduler: Scheduler = make_scheduler(scheduler, self.rng, **kw)
        self.model_dist = np.zeros(K)
        self.history: List[RoundRecord] = []
        self._round = 0

    # ------------------------------------------------------------------
    def run_round(self) -> RoundRecord:
        t = self._round
        h = self.channel.draw()
        ctx = ScheduleContext(h=h, Q=self.queues.Q, cost=self.cost,
                              params=self.params, bound=self.bound,
                              round_idx=t, model_dist=self.model_dist,
                              client_modalities=self.client_mods)
        t0 = time.perf_counter()
        dec = self.scheduler.schedule(ctx)
        sched_time = time.perf_counter() - t0

        tcom = wcost.com_latency(dec.B, h, self.cost.gamma_bits, self.params)
        ecom = wcost.com_energy(tcom, self.params)
        ok = dec.a & (tcom + self.cost.tau_cmp <= self.params.tau_max + 1e-12)
        failures = sorted(np.flatnonzero(dec.a & ~ok))
        participants = sorted(np.flatnonzero(ok))

        # --- local updates + aggregation (Eq. 12) + trackers ---
        seeds = self._draw_client_seeds()
        self.last_weights = self._round_batched(participants, seeds)
        self.queues.step(dec.a.astype(float), ecom, self.cost.e_cmp,
                         self.params.E_add)

        metrics = {}
        if t % self.eval_every == 0:
            metrics = self.adapter.evaluate(self.global_params, self.test_ds)
        rec = RoundRecord.make(t, participants, failures,
                               self.queues.spent.sum(), metrics, sched_time)
        self.history.append(rec)
        self._round += 1
        return rec

    def _draw_client_seeds(self) -> np.ndarray:
        """One dropout seed per client, every round, scheduled or not — K
        scalar draws, the JAX package's static consumption pattern."""
        return np.array([self.rng.integers(2 ** 31)
                         for _ in range(self.params.K)], np.uint32)

    def _round_batched(self, participants,
                       seeds: np.ndarray) -> Dict[str, np.ndarray]:
        """The whole cohort's updates as one cohort step."""
        K = self.params.K
        upload = {m: np.zeros(K, bool) for m in self.all_mods}
        for k in participants:
            for m in self.client_mods[k]:
                upload[m][k] = True
        if not len(participants):
            return agg.stacked_weights(self.data_sizes, upload)

        feats, labels, smask = self._get_stacked()
        newp, grads, _totals, dist_sq = self.adapter.batched_local_update(
            self.global_params, self.init_params, feats, labels, smask,
            upload, seeds)

        w_t = agg.stacked_weights(self.data_sizes, upload)
        self.global_params = agg.aggregate_stacked(self.global_params, newp,
                                                   w_t)
        agg_grads = agg.aggregate_gradients_stacked(grads, w_t)
        self.bound.update_stacked(grads, upload, agg_grads)

        d_sq = np.zeros(K)
        for m in self.all_mods:
            d_sq += dist_sq[m].cpu().numpy() * upload[m]
        part = np.asarray(participants, int)
        self.model_dist[part] = np.sqrt(d_sq[part])
        return w_t

    def _get_stacked(self):
        """Device-resident padded client stack, rebuilt if the cohort is
        swapped out (keyed on the identities of the ClientData objects)."""
        src = tuple(map(id, self.clients))
        if self._stacked_dev is None or self._stacked_src != src:
            sc = stack_clients(self.clients, self.all_mods)
            dev = self.device
            self._stacked_dev = (
                {m: torch.as_tensor(x, device=dev)
                 for m, x in sc.features.items()},
                torch.as_tensor(sc.labels, device=dev),
                torch.as_tensor(sc.sample_mask, device=dev))
            self._stacked_src = src
        return self._stacked_dev

    def run(self, rounds: int, verbose: bool = False) -> List[RoundRecord]:
        for _ in range(rounds):
            rec = self.run_round()
            if verbose and rec.metrics:
                acc = rec.metrics.get("multimodal", float("nan"))
                print(f"[{self.scheduler.name}] round {rec.round:4d} "
                      f"acc={acc:.4f} E={rec.energy_total:.3f}J "
                      f"sched={rec.sched_time_s * 1e3:.1f}ms "
                      f"part={rec.participants}")
        return self.history

    def final_metrics(self) -> Dict[str, float]:
        for rec in reversed(self.history):
            if rec.metrics:
                out = dict(rec.metrics)
                out["energy_total"] = self.history[-1].energy_total
                out["mean_sched_time_s"] = float(np.mean(
                    [r.sched_time_s for r in self.history]))
                return out
        return {}
