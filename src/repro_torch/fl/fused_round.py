"""The whole MFL round as one device program: schedule → cohort gather →
local updates → Eq. 12 aggregation → queue/tracker update → eval.

The counterpart of the JAX package's ``fl/fused_round.py``.  A round is
``_round_step(carry, xs) -> (carry, aux)``: the carry holds the evolving
experiment state on the device, ``xs`` the round's inputs drawn up front,
and nothing in the body reads a value back to the host.  Its shapes are
static for a given K, cohort size J and ``SolverHyper``.  So on a card the
round is captured once as a CUDA graph and replayed every round over
static carry and xs buffers (``FusedRoundEngine.step``); on the CPU the
same body runs eagerly, and the CPU tests hold that body against the JAX
package's.

What the JAX body does with ``lax.cond`` becomes:

* the eval cadence — two graphs that share one memory pool, one with the
  eval of the fresh globals and one without; the host picks one from
  ``xs.eval_flag``, a host tensor it knows without a read-back (rounds off
  the cadence emit NaN metrics, gated by ``RoundAux.eval_mask``);
* the empty-cohort skip — the cohort step runs unconditionally: with every
  upload mask 0 the loss's gradient is exactly 0, so the new params equal
  the old ones, the Eq. 12 weights are 0 (``aggregate_stacked_traced``
  keeps the globals) and the trackers and distances are masked, exactly
  the skip branch's result.

Random bits: the JAX body draws the policy's bits from
``PRNGKey(xs.draw_seed)`` inside the round.  Here ``RoundXs.draws`` carries
each round's policy draws, made up front by ``draw_round_xs`` through the
scheduler's draw source from the same one seed a round (default a
generator on the device seeded by it), so the numpy stream — channel draws,
the policy seed, K client seeds — is consumed in the host loop's order and
a fused run schedules as the host loop does.

The aux rows of a round are packed into one float32 vector on the device;
``run`` brings a round's (or a scan's [R, n]) rows back in one copy.
"""
from __future__ import annotations

import math
import time
import warnings
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core import aggregation as agg
from ..core.convergence import grad_gram, tracker_update_gram
from ..core.trees import tree_leaves, tree_map
from ..device import resolve_device
from ..kernels import launch_counts
from ..wireless.lyapunov import queue_update
from ..wireless.solver import build_solver_data
from ..wireless.solver.common import B_LO
from ..wireless.solver.torchsolver import rate, to_device
from .eval import device_test_set, eval_metrics, nan_metrics


class FusedCarry(NamedTuple):
    """Whole-experiment state carried from round to round (device)."""
    params: Dict[str, Any]
    policy: Dict[str, torch.Tensor]   # SchedulePolicy state (may be empty)
    Q: torch.Tensor               # [K] f32
    spent: torch.Tensor           # [K] f32
    zeta: torch.Tensor            # [M] f32
    delta: torch.Tensor           # [M, K] f32
    model_dist: torch.Tensor      # [K] f32


class RoundXs(NamedTuple):
    """A round's inputs (a leading [R] axis on every leaf for a scan)."""
    h: torch.Tensor               # [K] f32 channel gains (device)
    draw_seed: torch.Tensor       # int64, the policy seed (host, recorded)
    client_seeds: torch.Tensor    # [K] int64 dropout seeds (device)
    eval_flag: torch.Tensor       # bool, evaluate this round (host)
    draws: Dict[str, torch.Tensor]    # the policy's bits (device)


class RoundAux(NamedTuple):
    """A round's outputs — decoded on the host into a ``RoundRecord`` by
    ``MFLExperiment._decode_fused_round``."""
    a: Any                        # [K] bool, scheduled (failures included)
    ok: Any                       # [K] bool, participated
    J: Any                        # solver objective J₂(a*) (NaN: baselines)
    weights: Dict[str, Any]       # Eq. 12 weights w^t_{k,m}, [K] each
    energy_total: Any             # Σ_k cumulative energy after the round
    drop: Dict[str, Any]          # {m: [K] bool}, modality dropped
    metrics: Dict[str, Any]       # test metrics (NaN when not evaluated)
    eval_mask: Any                # bool, ``metrics`` is real


def tree_row(tree, i: int):
    """Row ``i`` of every leaf of a RoundXs / RoundAux tree (round ``i`` of
    a stack of rounds)."""
    return tree_map(lambda x: x[i], tree)


def draw_round_xs(exp, rounds: int, eval_every: Optional[int] = None
                  ) -> RoundXs:
    """``rounds`` rounds of the experiment's randomness, consumed in the
    host loop's order — per round K channel draws (``Channel.draw``), the
    one policy seed, then the K client seeds (``_draw_client_seeds``) —
    with each round's policy bits made from its seed by the scheduler's
    draw source (``round_draws``).  ``eval_flag`` marks the rounds the host
    loop would evaluate (``(exp._round + t) % exp.eval_every == 0``).

    ``eval_every`` is deprecated: the cadence is the experiment's setting
    (``MFLExperiment(eval_every=...)``)."""
    if eval_every is not None:
        warnings.warn(
            "draw_round_xs(eval_every=...) is deprecated; the eval cadence "
            "comes from the experiment — construct "
            "MFLExperiment(eval_every=...) instead",
            DeprecationWarning, stacklevel=2)
    K = exp.params.K
    ee = int(exp.eval_every if eval_every is None else eval_every)
    h = np.empty((rounds, K), np.float32)
    draw = np.empty(rounds, np.int64)
    cseed = np.empty((rounds, K), np.int64)
    flags = np.zeros(rounds, bool)
    bits = []
    for t in range(rounds):
        h[t] = exp.channel.draw()
        draw[t] = exp.rng.integers(2 ** 31)
        cseed[t] = exp._draw_client_seeds()
        flags[t] = (exp._round + t) % ee == 0
        bits.append(exp.scheduler.round_draws(int(draw[t])))
    return _stack_xs(h, draw, cseed, flags, bits, exp.device)


def draw_population_xs(channel, rng, K: int, rounds: int,
                       eval_every: int = 0, *,
                       policy, device="cuda", draw_source=None) -> RoundXs:
    """``draw_round_xs`` for ``from_store`` engines: per round K channel
    draws, one policy seed, K client seeds, from an explicit ``Channel``
    and numpy generator, and ``policy``'s bits from the seed
    (``draw_source(policy, seed)``, or a generator on ``device`` seeded by
    it).  ``eval_every <= 0`` flags no round."""
    dev = resolve_device(device)
    h = np.empty((rounds, K), np.float32)
    draw = np.empty(rounds, np.int64)
    cseed = np.empty((rounds, K), np.int64)
    flags = np.zeros(rounds, bool)
    bits = []
    for t in range(rounds):
        h[t] = channel.draw()
        draw[t] = rng.integers(2 ** 31)
        cseed[t] = rng.integers(2 ** 31, size=K, dtype=np.uint32)
        flags[t] = eval_every > 0 and t % eval_every == 0
        seed = int(draw[t])
        raw = (draw_source(policy, seed) if draw_source is not None else
               policy.draws(torch.Generator(device=dev).manual_seed(seed),
                            dev))
        bits.append({k: torch.as_tensor(v, device=dev)
                     for k, v in raw.items()})
    return _stack_xs(h, draw, cseed, flags, bits, dev)


def _stack_xs(h, draw, cseed, flags, bits, device) -> RoundXs:
    draws = ({k: torch.stack([b[k] for b in bits]) for k in bits[0]}
             if bits else {})
    return RoundXs(torch.as_tensor(h, device=device), torch.as_tensor(draw),
                   torch.as_tensor(cseed, device=device),
                   torch.as_tensor(flags), draws)


class FusedRoundEngine:
    """Per-experiment runner of the fused round.

    Holds the static device context — the ``ClientStore`` population, the
    solver template, the tracker constants, the held-out split for the
    in-round eval — and exposes:

    * ``step(carry, xs)`` — one round;
    * ``scan(carry, xs)`` — R rounds (xs leaves stacked [R, ...]), with no
      read-back until the end;
    * ``run(carry, xs, scanned)`` — either, timed, with the aux on the host;
    * ``init_carry()`` / ``export_carry()`` — host state ↔ carry.

    On a card ``step`` replays a captured CUDA graph (one per eval flag,
    captured at first use after an eager warm-up on a side stream, sharing
    one memory pool); the carry it returns is the engine's static buffers,
    overwritten by the next step.  ``capture_count`` counts captures — the
    contract is many rounds, one capture a graph; ``capture_seconds`` holds
    each graph's warm-up and capture time, ``graph_launches`` its kernel
    launches (the wrappers count only when Python launches, not on a
    replay) and ``replays`` its replays.

    ``from_store`` builds an engine straight from a ``ClientStore``,
    without an ``MFLExperiment``.
    """

    def __init__(self, exp):
        exp.scheduler.bind(exp.params.K, exp.client_mods)
        self.policy = exp.scheduler.policy
        if self.policy is None:
            raise ValueError(
                f"fused rounds require a policy on tensors "
                f"(wireless.policies); scheduler {exp.scheduler.name!r} "
                f"runs host-side only")
        self.exp = exp
        self.K = exp.params.K
        self.mods = list(exp.bound.mods)
        self.V = getattr(exp.scheduler, "V", 1.0)
        self.staleness = float(exp.bound.staleness)
        # the solver template: Q/h and the ζ²/δ² snapshot are overwritten
        # from the carry every round
        tmpl = build_solver_data(np.zeros(self.K), np.zeros(self.K),
                                 exp.cost, exp.params, exp.bound, self.V)
        tmpl["tau_cmp"] = np.asarray(exp.cost.tau_cmp, np.float64)
        self._setup(exp.device, tmpl, exp.params, exp._get_store(),
                    exp.init_params, exp.adapter,
                    device_test_set(exp.test_ds, exp.device))

    @classmethod
    def from_store(cls, store, params, policy, adapter, *, V: float = 1.0,
                   eta: float = 0.05, rho: float = 1.0,
                   staleness: float = 0.9, init_zeta: float = 1.0,
                   init_delta: float = 0.3, seed: int = 0, device="cuda"):
        """An engine straight from a numpy ``ClientStore`` (e.g.
        ``synthetic_population``), ``WirelessParams`` and a policy: the
        solver template comes from the store's cost and ownership arrays,
        the tracker initials are ``BoundState``'s.  Use ``fresh_carry()``
        for the matching initial carry; client 0's shard stands in as the
        held-out split."""
        self = cls.__new__(cls)
        self.exp = None
        self.policy = policy
        dev = resolve_device(device)
        self.K = store.K
        self.mods = list(store.modalities)
        self.V = float(V)
        self.staleness = float(staleness)
        self._init_zeta, self._init_delta = float(init_zeta), float(init_delta)
        np_ = (lambda x: x.detach().cpu().numpy()          # noqa: E731
               if isinstance(x, torch.Tensor) else np.asarray(x))
        has = np.stack([np_(store.has_modality[m]).astype(bool)
                        for m in self.mods])
        sizes = np_(store.sizes).astype(np.float64)
        wbar = agg.stacked_weights(sizes, {m: has[i] for i, m in
                                           enumerate(self.mods)})
        tau_cmp = np_(store.tau_cmp).astype(np.float64)
        tmpl = {
            "Q": np.zeros(self.K),
            "gamma": np_(store.gamma_bits).astype(np.float64),
            "h": np.zeros(self.K),
            "tau_rem": params.tau_max - tau_cmp,
            "tau_cmp": tau_cmp,
            "e_cmp": np_(store.e_cmp).astype(np.float64),
            "B_max": float(params.B_max),
            "p_tx": float(params.p_tx),
            "N0": float(params.N0),
            "V": float(V), "eta": float(eta), "rho": float(rho),
            "zeta2": np.full(len(self.mods), init_zeta ** 2),
            "delta2": np.full((len(self.mods), self.K), init_delta ** 2),
            "wbar": np.stack([wbar[m] for m in self.mods]),
            "has": has,
            "D": sizes,
        }
        dstore = store.to(dev)
        gp = adapter.init_global(torch.Generator().manual_seed(seed), dev)
        self._global_params0 = gp
        test = ({m: dstore.features[m][0] for m in self.mods},
                dstore.labels[0])
        self._setup(dev, tmpl, params, dstore, gp, adapter, test)
        return self

    def _setup(self, device, tmpl, params, store, init_params, adapter,
               test_set):
        self.device = device
        self._solver_tmpl = to_device(tmpl, device)
        self._tau_max = float(params.tau_max)
        self._E_add = float(params.E_add)
        self._p_tx = float(params.p_tx)
        self._N0 = float(params.N0)
        self._store = store
        self._init_params = init_params
        self._cohort = adapter.cohort_step
        # the adapter's deterministic forward backs the in-round eval, so
        # the fused metrics match adapter.evaluate for every model family
        self._eval_logits = adapter.eval_logits
        self._test_feats, self._test_labels = test_set
        # drop-mask row -> engine modality, for policies with dropout
        self._drop_rows = {m: i for i, m in
                           enumerate(getattr(self.policy, "drop_mods", ()))}
        self.capture_count = 0
        self.capture_seconds: Dict[bool, float] = {}
        self.graph_launches: Dict[bool, dict] = {}
        self.replays: Dict[bool, int] = {}
        self._graphs: Dict[bool, torch.cuda.CUDAGraph] = {}
        self._pool = None
        self._static_carry: Optional[FusedCarry] = None
        self._static_xs: Optional[RoundXs] = None
        self._static_aux: Optional[torch.Tensor] = None
        self._aux_spec = None

    # ------------------------------------------------------------------
    # host state ↔ carry
    # ------------------------------------------------------------------
    def init_carry(self) -> FusedCarry:
        exp, dev = self.exp, self.device

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return FusedCarry(
            params=exp.global_params,
            policy={k: torch.as_tensor(np.asarray(v), device=dev)
                    for k, v in exp.scheduler.state().items()},
            Q=f32(exp.queues.Q), spent=f32(exp.queues.spent),
            zeta=f32([exp.bound.zeta[m] for m in self.mods]),
            delta=f32(np.stack([exp.bound.delta[m] for m in self.mods])),
            model_dist=f32(exp.model_dist))

    def fresh_carry(self) -> FusedCarry:
        """Cold-start carry of a ``from_store`` engine: fresh globals,
        empty queues, ``BoundState``'s tracker initials."""
        M, K, dev = len(self.mods), self.K, self.device

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return FusedCarry(
            params=tree_map(torch.clone, self._global_params0),
            policy={k: torch.as_tensor(np.asarray(v), device=dev)
                    for k, v in self.policy.init_state().items()},
            Q=f32(np.zeros(K)), spent=f32(np.zeros(K)),
            zeta=f32(np.full(M, self._init_zeta)),
            delta=f32(np.full((M, K), self._init_delta)),
            model_dist=f32(np.zeros(K)))

    def round_params(self, carry: FusedCarry):
        """The carry's global params, straight off the device chain (no
        host mirror write, cf. ``export_carry``)."""
        return carry.params

    def export_carry(self, carry: FusedCarry) -> None:
        """Write the carry into the experiment's host mirrors in one
        device-to-host copy; ``global_params`` becomes a copy of the
        carry's params on the device (on a card the carry is the graph's
        static buffers, which the next replay overwrites in place)."""
        exp, M, K = self.exp, len(self.mods), self.K
        pol = sorted(carry.policy)
        parts = [carry.Q, carry.spent, carry.zeta, carry.delta.reshape(-1),
                 carry.model_dist] + [carry.policy[k].reshape(-1)
                                      for k in pol]
        host = torch.cat([p.to(torch.float64) for p in parts]).cpu().numpy()
        sizes = [K, K, M, M * K, K] + [carry.policy[k].numel() for k in pol]
        Q, spent, zeta, delta, dist, *vals = np.split(
            host, np.cumsum(sizes)[:-1])
        exp.global_params = tree_map(torch.clone, carry.params)
        exp.queues.Q, exp.queues.spent = Q, spent
        exp.queues.t = exp._round
        delta = delta.reshape(M, K)
        for i, m in enumerate(self.mods):
            exp.bound.zeta[m] = float(zeta[i])
            exp.bound.delta[m] = delta[i].copy()
        exp.model_dist = dist
        tmpl = exp.scheduler.state()
        exp.scheduler.load_state(
            {k: v.reshape(np.shape(tmpl[k])).astype(np.asarray(
                tmpl[k]).dtype) for k, v in zip(pol, vals)})

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------
    def _round_step(self, carry: FusedCarry, xs: RoundXs, store,
                    evaluate: bool):
        """One round, every step on the device, no read-back; the steps
        of the JAX package's body (``fl/fused_round.py:434-569``)."""
        dev = carry.Q.device
        # 1. server decision: the policy's step on the round's draws; the
        # policy state (warm start, cursor) rides in the carry
        data = dict(self._solver_tmpl)
        data["Q"], data["h"] = carry.Q, xs.h
        data["zeta2"] = torch.square(carry.zeta)
        data["delta2"] = torch.square(carry.delta)
        pstate, a, B, J, drop_rows, idx = self.policy.step_full(
            carry.policy, data, carry.model_dist, xs.draws)

        # 2. latency feasibility (C4): scheduled but late ⇒ failure
        r = rate(torch.clamp_min(B, B_LO), xs.h, self._p_tx, self._N0)
        tcom = torch.where(a, data["gamma"] / torch.clamp_min(r, 1e-30), 0.0)
        ok = a & (tcom + data["tau_cmp"] <= self._tau_max + 1e-12)

        # 3. cohort gather + masked BGD (Eq. 7) on the [J] stack; ok_c
        # masks failures and padding slots alike.  No skip for an empty
        # cohort: with every mask 0 the gradient is exactly 0, so the step
        # returns the globals unchanged, as the JAX body's skip branch
        idx_l = idx.to(torch.long)
        cohort = store.take(idx_l)
        seeds_c = xs.client_seeds.index_select(0, idx_l)
        ok_c = ok.index_select(0, idx_l)
        drop = {m: drop_rows[i] for m, i in self._drop_rows.items()
                if m in self.mods}       # empty for policies without dropout
        drop_c = {m: d.index_select(0, idx_l) for m, d in drop.items()}
        upload_c = agg.upload_masks_traced(ok_c, cohort.has_modality, drop_c)
        avail_c = {m: upload_c[m].to(torch.float32) for m in self.mods}
        newp_c, grads_c, _totals, dist_sq_c = self._cohort(
            carry.params, self._init_params, cohort.features, cohort.labels,
            cohort.sample_mask, avail_c, seeds_c)

        # 4. Eq. 12 on the cohort stack, the Gram-form ζ/δ refresh
        w_c = agg.stacked_weights_traced(cohort.sizes, upload_c)
        new_params = agg.aggregate_stacked_traced(carry.params, newp_c, w_c)
        w = agg.cohort_weights_dense(w_c, idx, self.K)
        zs, ds = [], []
        for i, m in enumerate(self.mods):
            z_m, d_m = tracker_update_gram(
                carry.zeta[i], carry.delta[i], grad_gram(grads_c[m]),
                w_c[m], upload_c[m], idx, data["has"][i], self.staleness)
            zs.append(z_m)
            ds.append(d_m)

        # 5. Lyapunov queues (§V-A) and energy
        used = a.to(torch.float32) * (self._p_tx * tcom + data["e_cmp"])
        Qn = queue_update(carry.Q, used, self._E_add)
        spent = carry.spent + used

        # 6. ‖θ_k − θ⁰‖ of the participants, scattered to the dense row
        d_sq_c = sum(dist_sq_c[m] * avail_c[m] for m in self.mods)
        dist_k = agg.scatter_cohort_rows(
            torch.where(ok_c, torch.sqrt(d_sq_c), 0.0), idx, self.K)
        model_dist = torch.where(ok, dist_k, carry.model_dist)

        # 7. eval of the fresh globals on the held-out split, on the
        # rounds the cadence flags
        if evaluate:
            metrics = eval_metrics(new_params, self._test_feats,
                                   self._test_labels,
                                   logits_fn=self._eval_logits)
        else:
            metrics = nan_metrics(self._test_feats, dev)

        new_carry = FusedCarry(new_params, pstate, Qn, spent,
                               torch.stack(zs), torch.stack(ds), model_dist)
        aux = RoundAux(a, ok, J, w, spent.sum(), drop, metrics,
                       torch.full((), evaluate, dtype=torch.bool,
                                  device=dev))
        return new_carry, aux

    # ------------------------------------------------------------------
    # aux rows: one float32 vector a round
    # ------------------------------------------------------------------
    def _pack(self, aux: RoundAux) -> torch.Tensor:
        if self._aux_spec is None:
            self._aux_spec = tree_map(lambda x: (tuple(x.shape), x.dtype),
                                      aux)
        return torch.cat([x.reshape(-1).to(torch.float32)
                          for x in tree_leaves(aux)])

    def _unpack(self, rows):
        """Packed rows ([n] or [R, n], tensor or numpy) → RoundAux with the
        same leading axes; bool leaves come back bool."""
        lead = tuple(rows.shape[:-1])
        at = 0

        def take(spec):
            nonlocal at
            shape, dtype = spec
            n = math.prod(shape)
            x = rows[..., at:at + n].reshape(lead + shape)
            at += n
            return x > 0.5 if dtype == torch.bool else x
        return tree_map(take, self._aux_spec)

    # ------------------------------------------------------------------
    # CUDA graphs
    # ------------------------------------------------------------------
    def _graph(self, evaluate: bool, carry: FusedCarry, xs: RoundXs):
        """The captured round for this eval flag, captured at first use:
        static buffers from the first carry and xs, an eager warm-up of
        the body on a side stream (library loads, ``cudaFuncSetAttribute``,
        cuBLAS and cuDNN handles, the policies' static tables), then the
        capture, which also copies the new carry into the static carry and
        the packed aux into the static aux row.  A failed capture raises:
        there is no eager fallback on a card."""
        if evaluate in self._graphs:
            return self._graphs[evaluate]
        dev = self.device
        t0 = time.perf_counter()
        if self._static_carry is None:
            self._static_carry = tree_map(lambda x: x.detach().clone(),
                                          carry)
            self._static_xs = RoundXs(
                xs.h.to(dev).clone(), xs.draw_seed,
                xs.client_seeds.to(dev).clone(), xs.eval_flag,
                {k: v.to(dev).clone() for k, v in xs.draws.items()})
        elif carry is not self._static_carry:
            self._copy_carry(carry)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                _, aux = self._round_step(self._static_carry,
                                          self._static_xs, self._store,
                                          evaluate)
                packed = self._pack(aux)
        torch.cuda.current_stream(dev).wait_stream(side)
        if self._static_aux is None:
            self._static_aux = torch.empty_like(packed)
        before = launch_counts()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self._pool):
            new, aux = self._round_step(self._static_carry, self._static_xs,
                                        self._store, evaluate)
            self._static_aux.copy_(self._pack(aux))
            for d, s in zip(tree_leaves(self._static_carry),
                            tree_leaves(new)):
                d.copy_(s)
        after = launch_counts()
        if self._pool is None:
            self._pool = g.pool()
        self.capture_count += 1
        self.capture_seconds[evaluate] = time.perf_counter() - t0
        self.graph_launches[evaluate] = {k: after[k] - before.get(k, 0)
                                         for k in after
                                         if after[k] - before.get(k, 0)}
        self.replays[evaluate] = 0
        self._graphs[evaluate] = g
        return g

    def _copy_carry(self, carry: FusedCarry):
        for d, s in zip(tree_leaves(self._static_carry),
                        tree_leaves(carry)):
            d.copy_(s)

    def _step_packed(self, carry: FusedCarry, xs: RoundXs):
        """(new carry, packed aux row [n] on the device)."""
        evaluate = bool(xs.eval_flag)           # a host tensor: no sync
        if self.device.type != "cuda":
            new, aux = self.step_eager(carry, xs)
            return new, self._pack(aux)
        g = self._graph(evaluate, carry, xs)
        if carry is not self._static_carry:
            self._copy_carry(carry)
        sx = self._static_xs
        sx.h.copy_(xs.h)
        sx.client_seeds.copy_(xs.client_seeds)
        for k, v in sx.draws.items():
            v.copy_(xs.draws[k])
        g.replay()
        self.replays[evaluate] += 1
        return self._static_carry, self._static_aux

    def step_eager(self, carry: FusedCarry, xs: RoundXs):
        """One round of the body run eagerly, on any device: (new carry,
        RoundAux of device tensors) — the reference a card's graph
        replays are held against."""
        return self._round_step(carry, xs, self._store, bool(xs.eval_flag))

    def step(self, carry: FusedCarry, xs: RoundXs):
        """One round: (new carry, RoundAux of device tensors)."""
        carry, row = self._step_packed(carry, xs)
        return carry, self._unpack(row.clone())

    def _scan_packed(self, carry: FusedCarry, xs: RoundXs):
        R = xs.h.shape[0]
        rows = None
        for i in range(R):
            carry, row = self._step_packed(carry, tree_row(xs, i))
            if rows is None:
                rows = torch.empty((R,) + tuple(row.shape),
                                   dtype=row.dtype, device=row.device)
            rows[i].copy_(row)
        return carry, rows

    def scan(self, carry: FusedCarry, xs: RoundXs):
        """R rounds (xs leaves [R, ...]) with no read-back in between:
        (final carry, RoundAux with [R]-leading device leaves)."""
        carry, rows = self._scan_packed(carry, xs)
        return carry, self._unpack(rows)

    def run(self, carry: FusedCarry, xs: RoundXs, scanned: bool):
        """Execute and time; returns (carry, RoundAux of numpy arrays —
        [R]-leading when ``scanned`` —, wall seconds).  The aux comes back
        in one device-to-host copy."""
        t0 = time.perf_counter()
        if scanned:
            carry, rows = self._scan_packed(carry, xs)
        else:
            carry, rows = self._step_packed(carry, xs)
        aux = self._unpack(rows.cpu().numpy())
        return carry, aux, time.perf_counter() - t0
