"""The wireless MFL loop — Algorithm 1 of the paper.

Per communication round t:
  1. redraw channel gains h_k;
  2. the server schedules clients and allocates bandwidth (JCSBA or a
     baseline, ``wireless.schedulers``).  JCSBA runs on the
     population-batched solver (``wireless.solver.torchsolver``) on the
     experiment's device; the engine spec's backend token
     (``"batched:np"`` / ``"batched:seq"``) selects its float64 numpy
     mirror or the original sequential scalar path;
  3. scheduled clients run the local update (one BGD epoch, Eq. 7) — clients
     whose latency constraint is violated under the chosen bandwidth are
     *transmission failures*: they consume energy but contribute no update;
  4. per-modality aggregation with participated weights (Eq. 12);
  5. Lyapunov queues and the Theorem-1 ζ/δ trackers are updated;
  6. test metrics (multimodal + per-modality accuracy) are recorded.

In the batched loop, step 3 runs all K clients' updates as one cohort step
over a dense, device-resident client stack
(``data.partition.StackedClients``): every modality is materialised for
every client at a fixed ``max_batch``, padding is masked out of the loss by
a ``sample_mask``, and a per-modality 0/1 upload mask [K] (scheduled ∧ no
transmission failure ∧ owns the modality ∧ did not drop it) zeroes the loss
— hence the gradient — of everything that is not uploaded.  Unscheduled
clients still run in the stack with avail = 0.

The engine spec keeps the JAX package's grammar,
``"<loop>[:<token>[+<token>...]]"``, and its three loops:

* ``seq`` — the reference: one local update per scheduled client on its
  unpadded shard (``ModelAdapter.local_update``), Eq. 12 over per-client
  dicts;
* ``batched`` (the default, ``"batched:pallas"``) — the cohort step above;
* ``fused`` — the whole round as one device program
  (``fl/fused_round.py``), captured once as a CUDA graph and replayed every
  round on a card; ``run_scanned(R)`` runs R rounds with one read-back.

The JCSBA solver backend is a token (``jax`` — the default —, ``np``,
``seq``; ``fused`` takes ``jax`` only); ``pallas`` selects the CUDA
fusion-loss kernel and, for the transformer/SSD backbones (``arch=``), the
flash-attention / SSD kernels in their mixers; ``remat`` checkpoints the
cohort forward.  Every loop consumes the experiment's numpy ``Generator``
in the JAX package's order — channel draw, the scheduler's one seed draw
(or the ``seq`` search's draws), K client seeds.  The scheduler's random
bits come from a draw source seeded by its draw (``wireless.schedulers``);
with the JAX package's bits injected (``scheduler_kwargs={"draw_source":
...}``) participants match the JAX package round by round.

``save``/``restore`` write and read the JAX package's checkpoint layout
(``checkpoint/``): a checkpoint of either package restores in the other.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import aggregation as agg
from ..core.convergence import BoundState
from ..core.trees import tree_map, tree_sq_dist
from ..data import synthetic
from ..data.partition import (build_client_store, partition, stack_clients,
                              train_test_split)
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
    #: modality -> sorted clients that dropped it this round ([28]'s
    #: modality-dropout baseline; empty for every other policy)
    dropped: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    @classmethod
    def make(cls, round, participants, failures, energy_total, metrics,
             sched_time_s, dropped=None) -> "RoundRecord":
        """Normalises every field to plain Python, so records are JSON-safe."""
        return cls(int(round), [int(v) for v in participants],
                   [int(v) for v in failures], float(energy_total),
                   {k: float(v) for k, v in metrics.items()},
                   float(sched_time_s),
                   {str(m): sorted(int(k) for k in ks)
                    for m, ks in (dropped or {}).items()})


#: valid ``engine=`` loop names, in increasing fusion order
ENGINE_LOOPS = ("seq", "batched", "fused")

#: valid "+"-joined engine-spec tokens after the ":"
ENGINE_TOKENS = ("jax", "np", "seq", "pallas", "remat")


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
                 eval_every: int = 1, engine: str = "batched:pallas",
                 arch: str = "lstm-cnn", device="cuda"):
        self.device = resolve_device(device)
        (loop, solver_backend, loss_backend, remat, use_kernels,
         self.engine) = parse_engine(engine)
        self.batched = loop == "batched"
        self.fused = loop == "fused"
        self._fused_engine = None           # built lazily (fl/fused_round.py)
        self._carry = None                  # FusedCarry when fused
        self._store_dev = None              # device-resident ClientStore
        self._store_src = None              # cohort it was built from
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
        kw.setdefault("device", self.device)
        if scheduler == "jcsba":
            kw.setdefault("V", V)
            kw.setdefault("solver", solver_backend)
        self.scheduler: Scheduler = make_scheduler(scheduler, self.rng, **kw)
        self.scheduler.bind(K, self.client_mods)
        if self.fused and self.scheduler.policy is None:
            raise ValueError(
                f"engine='fused' requires a scheduling policy on tensors; "
                f"scheduler={scheduler!r} with backend={solver_backend!r} "
                f"runs host-side only (every scheduler has one — jcsba, "
                f"random, round_robin, selection, dropout — except JCSBA's "
                f"np/seq parity backends)")
        self.model_dist = np.zeros(K)
        self.history: List[RoundRecord] = []
        self._round = 0

    # ------------------------------------------------------------------
    def run_round(self) -> RoundRecord:
        if self.fused:
            return self._run_round_fused()
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
        if self.batched:
            w_t = self._round_batched(dec, participants, seeds)
        else:
            w_t = self._round_sequential(dec, participants, seeds)
        self.last_weights = w_t
        self.queues.step(dec.a.astype(float), ecom, self.cost.e_cmp,
                         self.params.E_add)

        metrics = {}
        if t % self.eval_every == 0:
            metrics = self.adapter.evaluate(self.global_params, self.test_ds)
        dropped: Dict[str, List[int]] = {}
        if dec.dropout_modality:
            for k, m in enumerate(dec.dropout_modality):
                if m is not None:
                    dropped.setdefault(m, []).append(k)
        rec = RoundRecord.make(t, participants, failures,
                               self.queues.spent.sum(), metrics, sched_time,
                               dropped)
        self.history.append(rec)
        self._round += 1
        return rec

    # ------------------------------------------------------------------
    # the fused loop (fl/fused_round.py): the whole round on the device
    # ------------------------------------------------------------------
    def _get_fused_engine(self):
        if self._fused_engine is None:
            from .fused_round import FusedRoundEngine
            self._fused_engine = FusedRoundEngine(self)
        if self._carry is None:
            self._carry = self._fused_engine.init_carry()
        return self._fused_engine

    def _decode_fused_round(self, t: int, aux, sched_time: float
                            ) -> RoundRecord:
        """Host decode of one round's aux (numpy) into a RoundRecord; the
        metrics are real only on rounds the cadence flagged."""
        a = np.asarray(aux.a, bool)
        ok = np.asarray(aux.ok, bool)
        self.last_weights = {m: np.asarray(aux.weights[m], np.float64)
                             for m in self.all_mods}
        metrics = {}
        if bool(aux.eval_mask):
            metrics = {k: float(v) for k, v in aux.metrics.items()}
        dropped = {m: np.flatnonzero(np.asarray(d, bool))
                   for m, d in aux.drop.items()}
        return RoundRecord.make(t, sorted(np.flatnonzero(ok)),
                                sorted(np.flatnonzero(a & ~ok)),
                                aux.energy_total, metrics, sched_time,
                                {m: ks for m, ks in dropped.items()
                                 if len(ks)})

    def _run_round_fused(self) -> RoundRecord:
        # the record's sched_time_s holds the whole fused round's wall time
        # (the stages are one program; the first round on a card includes
        # the graph's warm-up and capture)
        from .fused_round import draw_round_xs, tree_row
        eng = self._get_fused_engine()
        xs = tree_row(draw_round_xs(self, 1), 0)
        self._carry, aux, wall = eng.run(self._carry, xs, scanned=False)
        rec = self._decode_fused_round(self._round, aux, wall)
        self.history.append(rec)
        self._round += 1
        # the host mirrors (global_params, queues, bound, model_dist) stay
        # live; the carry stays the source of truth
        eng.export_carry(self._carry)
        return rec

    def run_scanned(self, rounds: int) -> List[RoundRecord]:
        """R fused rounds with the randomness drawn up front in the host
        loop's order and one read-back at the end — the same rounds as R
        ``run_round()`` calls.  Metrics are evaluated inside on the
        ``eval_every`` grid; ``sched_time_s`` records the mean wall time a
        round of the whole scan."""
        if not self.fused:
            raise RuntimeError("run_scanned requires engine='fused'")
        from .fused_round import draw_round_xs, tree_row
        eng = self._get_fused_engine()
        xs = draw_round_xs(self, rounds)
        self._carry, auxs, wall = eng.run(self._carry, xs, scanned=True)
        start, per = self._round, wall / max(rounds, 1)
        recs = [self._decode_fused_round(start + i, tree_row(auxs, i), per)
                for i in range(rounds)]
        self.history.extend(recs)
        self._round += rounds
        eng.export_carry(self._carry)
        return recs

    # ------------------------------------------------------------------
    # local-update fan-out: sequential (reference) and batched
    # ------------------------------------------------------------------
    def _draw_client_seeds(self) -> np.ndarray:
        """One dropout seed per client, every round, scheduled or not — K
        scalar draws, the JAX package's static consumption pattern."""
        return np.array([self.rng.integers(2 ** 31)
                         for _ in range(self.params.K)], np.uint32)

    def _round_sequential(self, dec, participants,
                          seeds: np.ndarray) -> Dict[str, np.ndarray]:
        """The reference path: one local update per scheduled client."""
        K = self.params.K
        client_params: List[Optional[dict]] = [None] * K
        client_grads: List[Optional[dict]] = [None] * K
        for k in participants:
            drop = (dec.dropout_modality[k]
                    if dec.dropout_modality is not None else None)
            newp, grads, _ = self.adapter.local_update(
                self.global_params, self.clients[k], int(seeds[k]), drop)
            client_params[k] = newp
            client_grads[k] = grads
            self.model_dist[k] = float(np.sqrt(float(tree_sq_dist(
                newp, {m: self.init_params[m] for m in newp}))))
        # participated weights (Eq. 12), renormalised over what was
        # uploaded (a dropped modality is absent from the upload)
        w_t = agg.weights_from_uploads(self.data_sizes, client_params,
                                       self.all_mods)
        self.global_params = agg.aggregate(self.global_params, client_params,
                                           w_t)
        agg_grads = agg.aggregate_gradients(client_grads, w_t)
        self.bound.update(client_grads, agg_grads)
        return w_t

    def _round_batched(self, dec, participants,
                       seeds: np.ndarray) -> Dict[str, np.ndarray]:
        """The whole cohort's updates as one cohort step; a dropped modality
        leaves the client's upload (unless it was the client's only one)."""
        K = self.params.K
        upload = {m: np.zeros(K, bool) for m in self.all_mods}
        for k in participants:
            drop = (dec.dropout_modality[k]
                    if dec.dropout_modality is not None else None)
            mods = tuple(m for m in self.client_mods[k] if m != drop)
            if not mods:
                mods = tuple(self.client_mods[k])
            for m in mods:
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

    def _get_store(self):
        """Device-resident ``ClientStore`` (the fused round's population
        store), rebuilt if the cohort is swapped out, as ``_get_stacked``."""
        src = tuple(map(id, self.clients))
        if self._store_dev is None or self._store_src != src:
            sc = stack_clients(self.clients, self.all_mods)
            self._store_dev = build_client_store(
                sc, self.cost.gamma_bits, self.cost.tau_cmp,
                self.cost.e_cmp).to(self.device)
            self._store_src = src
        return self._store_dev

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

    # ------------------------------------------------------------------
    # checkpoint / resume (server state: global model, queues, trackers)
    # ------------------------------------------------------------------
    def save(self, path: str) -> str:
        """The server state in the JAX package's checkpoint layout."""
        from ..checkpoint import save_checkpoint
        if self.fused and self._carry is not None:
            # the carry is authoritative mid-fused-experiment
            self._fused_engine.export_carry(self._carry)
        state = {
            "global_params": self.global_params,
            "queues_Q": self.queues.Q,
            "queues_spent": self.queues.spent,
            "delta": {m: self.bound.delta[m] for m in self.all_mods},
            "model_dist": self.model_dist,
            # the policy's own state (JCSBA warm start, Round-Robin cursor)
            "policy": self.scheduler.state(),
        }
        meta = {"round": self._round,
                "zeta": {m: float(self.bound.zeta[m]) for m in self.all_mods},
                "queues_t": self.queues.t}
        return save_checkpoint(path, state, step=self._round, metadata=meta)

    def restore(self, path: str) -> int:
        """Restore a checkpoint of either package; returns its round."""
        from ..checkpoint import load_checkpoint
        from ..convert import params_from_numpy
        state, manifest = load_checkpoint(path)
        self.global_params = params_from_numpy(state["global_params"],
                                               self.device)
        self.queues.Q = np.asarray(state["queues_Q"])
        self.queues.spent = np.asarray(state["queues_spent"])
        self.queues.t = manifest["metadata"]["queues_t"]
        for m in self.all_mods:
            self.bound.delta[m] = np.asarray(state["delta"][m])
            self.bound.zeta[m] = manifest["metadata"]["zeta"][m]
        self.model_dist = np.asarray(state["model_dist"])
        # stateless policies saved nothing (the empty dict flattens away);
        # checkpoints from before the policy layer hold the JCSBA warm
        # start as a top-level "warm_a" blob — restored, but deprecated
        pol = state.get("policy")
        if pol is None and "warm_a" in state:
            warnings.warn(
                "checkpoint uses the legacy top-level 'warm_a' warm-start "
                "blob; restored this time — re-save the experiment to "
                "migrate to the policy/ state-dict format (see README "
                "'Checkpoint migration')",
                DeprecationWarning, stacklevel=2)
            pol = {"warm_a": state["warm_a"]}
        if pol:
            self.scheduler.load_state(pol)
        self._round = manifest["step"]
        if self.fused:
            # rebuild the carry from the restored host state
            self._carry = None
            self._get_fused_engine()
        return self._round

    # ------------------------------------------------------------------
    def final_metrics(self) -> Dict[str, float]:
        for rec in reversed(self.history):
            if rec.metrics:
                out = dict(rec.metrics)
                out["energy_total"] = self.history[-1].energy_total
                out["mean_sched_time_s"] = float(np.mean(
                    [r.sched_time_s for r in self.history]))
                return out
        return {}
