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

What the JAX package's ``vmap`` over scenarios computes
(``scan_scenario_grid``) runs here row by row over the same captured
round: each scenario's solver-data rows, store and test split are copied
into the static tensors the graph reads (the population kernel reads V
from one of them), its R rounds replay, and its final carry and aux rows
are copied out.

On more than one device the port is SPMD, one process a rank (the caller
initializes the default process group; every rank calls with the same
arguments and gets the whole result back, as the JAX package's single
controller gets a global array):

* a 1-D ``("scenario",)`` mesh (``launch.mesh.make_sweep_mesh``) splits a
  grid's rows: each rank replays its block through its own captured round
  pair, with no collective in the graph, and ``gather_leading`` hands
  every rank the whole grid at the end;
* a 2-D ``("scenario", "clients")`` mesh (``make_population_mesh``) also
  splits the client store: each rank holds K/n_clients rows of it and its
  columns of ``xs.h`` and ``xs.client_seeds``, and the round reassembles
  the channel draw, JCSBA's B_min and the cohort's rows over the
  ``"clients"`` group (``_round_step(axis=)``); everything else in the
  body runs replicated.  Collectives are captured under NCCL (after the
  eager warm-up has created the communicator); gloo stages through the
  host and cannot be captured, so under gloo the body runs eagerly
  (``round_body``).
"""
from __future__ import annotations

import copy
import math
import time
import warnings
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import aggregation as agg
from ..core.convergence import grad_gram, tracker_update_gram
from ..core.trees import tree_leaves, tree_map
from ..device import graph_capture, resolve_device
from ..kernels import launch_counts
from ..kernels.jcsba_solver.ops import bmin as _bmin
from ..launch.mesh import axis_names, axis_sizes, make_sweep_mesh
from ..launch.sharding import (gather_leading, leading_block,
                               logical_pspec, masked_sum, pad_leading_axis,
                               slice_leading_axis)
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


def draw_round_xs(exp, rounds: int, eval_every: Optional[int] = None,
                  include_final: bool = False) -> RoundXs:
    """``rounds`` rounds of the experiment's randomness, consumed in the
    host loop's order — per round K channel draws (``Channel.draw``), the
    one policy seed, then the K client seeds (``_draw_client_seeds``) —
    with each round's policy bits made from its seed by the scheduler's
    draw source (``round_draws``).  ``eval_flag`` marks the rounds the host
    loop would evaluate (``(exp._round + t) % exp.eval_every == 0``);
    ``include_final`` also flags the last round, so a sweep's every curve
    ends with the final model's metrics whatever the cadence.

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
    if include_final and rounds:
        flags[-1] = True
    return _stack_xs(h, draw, cseed, flags, bits, exp.device)


def draw_population_xs(channel, rng, K: int, rounds: int,
                       eval_every: int = 0, include_final: bool = False, *,
                       policy, device="cuda", draw_source=None) -> RoundXs:
    """``draw_round_xs`` for ``from_store`` engines: per round K channel
    draws, one policy seed, K client seeds, from an explicit ``Channel``
    and numpy generator, and ``policy``'s bits from the seed
    (``draw_source(policy, seed)``, or a generator on ``device`` seeded by
    it).  ``eval_every <= 0`` flags no round of the cadence;
    ``include_final`` flags the last round all the same (the scenario
    zoo's convention)."""
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
    if include_final and rounds:
        flags[-1] = True
    return _stack_xs(h, draw, cseed, flags, bits, dev)


def _stack_xs(h, draw, cseed, flags, bits, device) -> RoundXs:
    draws = ({k: torch.stack([b[k] for b in bits]) for k in bits[0]}
             if bits else {})
    return RoundXs(torch.as_tensor(h, device=device), torch.as_tensor(draw),
                   torch.as_tensor(cseed, device=device),
                   torch.as_tensor(flags), draws)


def _gather_rows(x, idx, group):
    """Cross-shard cohort gather under a client-sharded mesh.

    ``x`` is this rank's [K_loc, ...] block of a client-axis leaf; ``idx``
    [J] holds *global* client indices (replicated).  Each rank takes the
    rows it owns, puts the sum's identity in the others (``-0.0`` for
    floats, so a ``-0.0`` feature comes back as it is; 0 for integers; bool
    travels as int32) and the sum over ``group`` reassembles the cohort —
    exact for every dtype: each output element receives one rank's value
    (``launch.sharding.masked_sum``)."""
    K_loc = x.shape[0]
    local = idx - dist.get_rank(group) * K_loc
    mine = (local >= 0) & (local < K_loc)
    rows = x.index_select(0, local.clamp(0, K_loc - 1))
    return masked_sum(rows, mine, group)


def _clients_group(mesh, K):
    """The group of ``mesh``'s ``"clients"`` axis (None: no mesh, or a mesh
    without that axis); K must divide it, as in the JAX package."""
    if mesh is None or logical_pspec(("clients",), mesh)[0] is None:
        return None
    n = axis_sizes(mesh)["clients"]
    if K % n:
        raise ValueError(f"K={K} must divide the mesh's clients axis "
                         f"({n} shards)")
    return mesh.get_group("clients")


def _client_block(K, group):
    """This rank's block of the K clients on a client axis's ``group``."""
    return leading_block(K, dist.get_world_size(group), dist.get_rank(group))


class FusedRoundEngine:
    """Per-experiment runner of the fused round.

    Holds the static device context — the ``ClientStore`` population, the
    solver template, the tracker constants, the held-out split for the
    in-round eval — and exposes:

    * ``step(carry, xs)`` — one round;
    * ``scan(carry, xs)`` — R rounds (xs leaves stacked [R, ...]), with no
      read-back until the end;
    * ``run(carry, xs, scanned)`` — either, timed, with the aux on the host;
    * ``scan_scenario_grid`` / ``scan_v_grid`` — whole experiments over a
      grid of scenarios, the captured round replayed row by row;
    * ``init_carry()`` / ``export_carry()`` — host state ↔ carry.

    On a card ``step`` replays a captured CUDA graph (one per eval flag,
    captured at first use after an eager warm-up on a side stream, sharing
    one memory pool, and a third, ``"grid"``, for eval on a scenario grid's
    test split); the carry it returns is the engine's static buffers,
    overwritten by the next step.  ``capture_count`` counts captures — the
    contract is many rounds, one capture a graph; ``capture_seconds`` holds
    each graph's warm-up and capture time, ``graph_launches`` its kernel
    launches (the wrappers count only when Python launches, not on a
    replay) and ``replays`` its replays, each keyed by graph.

    ``from_store`` builds an engine straight from a ``ClientStore``,
    without an ``MFLExperiment``; with ``mesh=`` a ``("scenario",
    "clients")`` mesh it keeps only this rank's block of the clients.
    ``round_body`` says how a round runs on a card: ``"captured"`` (graph
    replays), or ``"eager"`` when the client axis's group is gloo, whose
    collectives cannot be captured.
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
                   init_delta: float = 0.3, seed: int = 0, device="cuda",
                   mesh=None):
        """An engine straight from a numpy ``ClientStore`` (e.g.
        ``synthetic_population``), ``WirelessParams`` and a policy: the
        solver template comes from the store's cost and ownership arrays,
        the tracker initials are ``BoundState``'s.  Use ``fresh_carry()``
        for the matching initial carry; a copy of client 0's shard stands
        in as the held-out split.  The engine keeps its own copy of the
        store (a scenario grid swaps rows into it).

        ``mesh``: a mesh with a ``"clients"`` axis (``launch.mesh.
        make_population_mesh``) keeps only this rank's block of K/n_clients
        clients on the device; the solver template stays whole.  Its rounds
        run client-sharded (``_round_step(axis=)``): every rank of the axis
        calls each round with the same arguments, the whole ``xs``
        included.  A mesh without that axis shards nothing."""
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
        test = ({m: torch.tensor(np_(store.features[m][0]), device=dev)
                 for m in self.mods},
                torch.tensor(np_(store.labels[0]), device=dev))
        axis = _clients_group(mesh, self.K)
        if axis is not None:
            blk = _client_block(self.K, axis)
            store = store._map(lambda x: x[blk])
        dstore = store.to(dev)
        if dev.type == "cpu":       # ``to`` wraps the numpy leaves there
            dstore = dstore._map(torch.clone)
        gp = adapter.init_global(torch.Generator().manual_seed(seed), dev)
        self._global_params0 = gp
        self._setup(dev, tmpl, params, dstore, gp, adapter, test, axis)
        return self

    def _setup(self, device, tmpl, params, store, init_params, adapter,
               test_set, axis=None):
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
        self._client_twins = {}         # mesh -> client-sharded twin
        self._set_axis(axis)
        self._reset_graphs()

    def _set_axis(self, axis):
        """The client axis's group (None: unsharded), this rank's block of
        the clients, and how a round runs: captured on a card unless the
        group's collectives cannot be captured (gloo)."""
        self._axis = axis
        self._block = None if axis is None else _client_block(self.K, axis)
        self.round_body = (
            "captured" if self.device.type == "cuda" and (
                axis is None or dist.get_backend(axis) == "nccl")
            else "eager")

    def _reset_graphs(self):
        self.capture_count = 0
        self.capture_seconds: Dict[Any, float] = {}
        self.graph_launches: Dict[Any, dict] = {}
        self.replays: Dict[Any, int] = {}
        self._graphs: Dict[Any, torch.cuda.CUDAGraph] = {}
        self._pool = None
        # a scenario grid's held-out split: static buffers at the grid's
        # test shape, read by the grid's own eval graph (key "grid")
        self._grid_test = None
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
                    evaluate: bool, overrides=None, test_set=None,
                    axis=None):
        """One round, every step on the device, no read-back; the steps
        of the JAX package's body (``fl/fused_round.py:434-569``).

        ``store`` is the (possibly rank-local) store; ``axis`` the process
        group the store and the per-client xs leaves (``h``,
        ``client_seeds``: this rank's columns) are split over (None:
        unsharded).  Cohort compute runs replicated over the axis — only
        the O(K·N·d) store and the per-client randomness are split.
        ``overrides`` replaces solver-template entries for this round (a
        scenario's V, ownership, Eq. 12 denominators and costs, as device
        tensors); ``test_set`` is a ``(features, labels)`` pair evaluated
        in place of the engine's held-out split."""
        dev = carry.Q.device
        # 0. under a client-sharded mesh the vector physics stays dense and
        # replicated: reassemble the whole channel draw
        h = xs.h if axis is None else gather_leading(xs.h, axis)

        # 1. server decision: the policy's step on the round's draws; the
        # policy state (warm start, cursor) rides in the carry
        data = dict(self._solver_tmpl)
        if overrides:
            data.update(overrides)
        data["Q"], data["h"] = carry.Q, h
        data["zeta2"] = torch.square(carry.zeta)
        data["delta2"] = torch.square(carry.delta)
        if axis is not None and hasattr(self.policy, "hp"):
            # the KKT B_min bisection is the solver's only per-client
            # compute: run it on this rank's block and reassemble —
            # elementwise, so exact
            K_loc = xs.h.shape[0]
            off = dist.get_rank(axis) * K_loc
            bl, okl = _bmin(data["gamma"][off:off + K_loc], xs.h,
                            data["tau_rem"][off:off + K_loc],
                            data["B_max"], data["p_tx"], data["N0"],
                            self.policy.hp)
            data["bmin"] = gather_leading(bl, axis)
            data["bmin_ok"] = gather_leading(okl, axis)
        pstate, a, B, J, drop_rows, idx = self.policy.step_full(
            carry.policy, data, carry.model_dist, xs.draws)

        # 2. latency feasibility (C4): scheduled but late ⇒ failure
        r = rate(torch.clamp_min(B, B_LO), h, self._p_tx, self._N0)
        tcom = torch.where(a, data["gamma"] / torch.clamp_min(r, 1e-30), 0.0)
        ok = a & (tcom + data["tau_cmp"] <= self._tau_max + 1e-12)

        # 3. cohort gather + masked BGD (Eq. 7) on the [J] stack; ok_c
        # masks failures and padding slots alike.  No skip for an empty
        # cohort: with every mask 0 the gradient is exactly 0, so the step
        # returns the globals unchanged, as the JAX body's skip branch
        idx_l = idx.to(torch.long)
        if axis is None:
            cohort = store.take(idx_l)
            seeds_c = xs.client_seeds.index_select(0, idx_l)
        else:
            cohort = store._map(lambda x: _gather_rows(x, idx_l, axis))
            seeds_c = _gather_rows(xs.client_seeds, idx_l, axis)
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
        tf, tl = test_set if test_set is not None else \
            (self._test_feats, self._test_labels)
        if evaluate:
            metrics = eval_metrics(new_params, tf, tl,
                                   logits_fn=self._eval_logits)
        else:
            metrics = nan_metrics(tf, dev)

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
    def _graph(self, key, carry: FusedCarry, xs: RoundXs, test_set=None):
        """The captured round for ``key`` — True (eval on the engine's
        held-out split), False (no eval) or ``"grid"`` (eval on a scenario
        grid's static test buffers, ``test_set``) — captured at first use:
        static buffers from the first carry and xs, an eager warm-up of
        the body on a side stream (library loads, ``cudaFuncSetAttribute``,
        cuBLAS and cuDNN handles, the policies' static tables, the NCCL
        communicator of a client axis), then the
        capture, which also copies the new carry into the static carry and
        the packed aux into the static aux row.  A failed capture raises:
        there is no eager fallback on a card."""
        if key in self._graphs:
            return self._graphs[key]
        evaluate = key is not False
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
                                          evaluate, test_set=test_set,
                                          axis=self._axis)
                packed = self._pack(aux)
        torch.cuda.current_stream(dev).wait_stream(side)
        if self._static_aux is None:
            self._static_aux = torch.empty_like(packed)
        before = launch_counts()
        g = torch.cuda.CUDAGraph()
        with graph_capture(g, pool=self._pool):
            new, aux = self._round_step(self._static_carry, self._static_xs,
                                        self._store, evaluate,
                                        test_set=test_set, axis=self._axis)
            self._static_aux.copy_(self._pack(aux))
            for d, s in zip(tree_leaves(self._static_carry),
                            tree_leaves(new)):
                d.copy_(s)
        after = launch_counts()
        if self._pool is None:
            self._pool = g.pool()
        self.capture_count += 1
        self.capture_seconds[key] = time.perf_counter() - t0
        self.graph_launches[key] = {k: after[k] - before.get(k, 0)
                                    for k in after
                                    if after[k] - before.get(k, 0)}
        self.replays[key] = 0
        self._graphs[key] = g
        return g

    def _copy_carry(self, carry: FusedCarry):
        for d, s in zip(tree_leaves(self._static_carry),
                        tree_leaves(carry)):
            d.copy_(s)

    def _local_xs(self, xs: RoundXs) -> RoundXs:
        """This rank's columns of the per-client xs leaves (``h``,
        ``client_seeds``) on a client-sharded engine; ``xs`` otherwise."""
        if self._axis is None:
            return xs
        blk = self._block
        return xs._replace(h=xs.h[..., blk],
                           client_seeds=xs.client_seeds[..., blk])

    def _step_packed(self, carry: FusedCarry, xs: RoundXs, test_set=None):
        """(new carry, packed aux row [n] on the device); ``test_set``: a
        scenario grid's static test buffers, evaluated in place of the
        engine's held-out split."""
        evaluate = bool(xs.eval_flag)           # a host tensor: no sync
        xs = self._local_xs(xs)
        if self.round_body == "eager":
            new, aux = self._round_step(carry, xs, self._store, evaluate,
                                        test_set=test_set, axis=self._axis)
            return new, self._pack(aux)
        key = "grid" if evaluate and test_set is not None else evaluate
        g = self._graph(key, carry, xs, test_set)
        if carry is not self._static_carry:
            self._copy_carry(carry)
        sx = self._static_xs
        sx.h.copy_(xs.h)
        sx.client_seeds.copy_(xs.client_seeds)
        for k, v in sx.draws.items():
            v.copy_(xs.draws[k])
        g.replay()
        self.replays[key] += 1
        return self._static_carry, self._static_aux

    def step_eager(self, carry: FusedCarry, xs: RoundXs):
        """One round of the body run eagerly, on any device: (new carry,
        RoundAux of device tensors) — the reference a card's graph
        replays are held against."""
        return self._round_step(carry, self._local_xs(xs), self._store,
                                bool(xs.eval_flag), axis=self._axis)

    def step(self, carry: FusedCarry, xs: RoundXs):
        """One round: (new carry, RoundAux of device tensors)."""
        carry, row = self._step_packed(carry, xs)
        return carry, self._unpack(row.clone())

    def _scan_packed(self, carry: FusedCarry, xs: RoundXs, test_set=None):
        R = xs.h.shape[0]
        rows = None
        for i in range(R):
            carry, row = self._step_packed(carry, tree_row(xs, i), test_set)
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

    # ------------------------------------------------------------------
    # scenario grids
    # ------------------------------------------------------------------
    def scan_scenario_grid(self, overrides, carry: FusedCarry, xs: RoundXs,
                           stores=None, test_sets=None, mesh="auto"):
        """Whole experiments over a scenario grid: every row runs the full
        R-round experiment from the shared initial ``carry`` on the shared
        randomness ``xs`` (the controlled-comparison convention of the JAX
        package's ``scan_scenario_grid``).

        ``overrides`` is a dict of stacked solver-template entries, each
        with a leading [S] scenario axis over the per-round shape (``V`` →
        [S], ``gamma``/``tau_rem``/``tau_cmp``/``e_cmp``/``D`` → [S, K],
        ``has``/``wbar`` → [S, M, K]; ``data/scenarios.py:stack_scenarios``
        assembles it).  ``stores`` optionally stacks per-scenario
        ``ClientStore``s ([S]-leading leaves, the engine's geometry; None:
        every row reads the engine's store) and ``test_sets`` an
        ``(features, labels)`` pair with [S]-leading leaves for
        per-scenario eval.

        One captured round serves every row: each scenario's rows are
        copied into the static tensors the round reads (the solver
        template's entries, the store, the grid's test buffers), then its R
        rounds replay as ``scan`` replays them (on the CPU the body runs
        eagerly on the same buffers).  Nothing is read back; afterwards the
        engine's own buffers are put back.  Returns ``(carries, auxs)``:
        ``FusedCarry`` leaves [S, ...], ``RoundAux`` leaves [S, R, ...], on
        the device.

        ``mesh``: ``"auto"`` builds a 1-D ``("scenario",)`` mesh over the
        default group's ranks (``launch.mesh.make_sweep_mesh``; None on a
        world of 1), None runs on the engine's one device.  On a 1-D mesh of
        n ranks the grid is padded to a multiple of n by repeating its last
        row, each rank runs its block of rows as above, and every rank gets
        the whole grid back (``launch.sharding.gather_leading``), equal to
        the one-device sweep.  The 2-D ``("scenario", "clients")`` mesh is
        V-grid-only: run it through ``scan_v_grid``."""
        if isinstance(mesh, str) and mesh == "auto":
            mesh = make_sweep_mesh(device=self.device)
        ovr, stores, test_sets, n_S = self._grid_inputs(overrides, stores,
                                                        test_sets)
        if mesh is None or mesh.size() <= 1:
            carries, rows = self._grid_packed(ovr, stores, test_sets, carry,
                                              xs, n_S)
            return carries, self._unpack(rows)
        if "clients" in axis_names(mesh):
            raise ValueError(
                "scan_scenario_grid supports 1-D ('scenario',) meshes only; "
                "the 2-D ('scenario', 'clients') population mesh shards the "
                "client store itself — run V-only grids there via "
                "scan_v_grid")
        if self._axis is not None:
            raise ValueError("an engine built on a client mesh splits its "
                             "rounds over that mesh's ranks: sweep with "
                             "mesh=None or that mesh")
        carries, rows = self._sharded_rows(ovr, stores, test_sets, carry,
                                           xs, mesh.get_group("scenario"),
                                           n_S)
        return carries, self._unpack(rows)

    def scan_v_grid(self, V_grid, carry: FusedCarry, xs: RoundXs,
                    mesh="auto"):
        """Whole experiments over a drift-penalty grid — the paper's Fig. 4
        V study: ``scan_scenario_grid({"V": V_grid})``, the engine's store
        and test split shared by every row.

        ``mesh`` as ``scan_scenario_grid``'s; a 2-D ``("scenario",
        "clients")`` mesh (``launch.mesh.make_population_mesh``) also splits
        the client store and the per-client randomness over the
        ``"clients"`` axis: each rank holds K/n_clients rows of every
        O(K·N·d) leaf (an engine built ``from_store(mesh=)`` holds only
        those; otherwise views of them), and the round reassembles what it
        needs over the axis (``_round_step(axis=)``).  The V grid is padded
        over ``"scenario"`` and sliced back; K must divide the clients
        axis.  Sharded and one-device sweeps give the same results."""
        if isinstance(mesh, str) and mesh == "auto":
            mesh = make_sweep_mesh(device=self.device)
        V = np.asarray(V_grid, np.float32)
        if mesh is None or mesh.size() <= 1 or \
                "clients" not in axis_names(mesh):
            return self.scan_scenario_grid({"V": V}, carry, xs, mesh=mesh)
        eng = self._client_engine(mesh)
        ovr = eng._grid_inputs({"V": V}, None, None)[0]
        carries, rows = eng._sharded_rows(ovr, None, None, carry, xs,
                                          mesh.get_group("scenario"),
                                          V.shape[0])
        return carries, eng._unpack(rows)

    def _sharded_rows(self, ovr, stores, test_sets, carry, xs, group, n_S):
        """A grid's S rows split over ``group``'s ranks: the [S]-leading
        inputs padded to a multiple of the group's size (the last row
        repeated), this rank's block run as ``_grid_packed`` runs a grid,
        every rank's block gathered back (``gather_leading``): (carries
        [S, ...], packed aux rows [S, R, n]) on every rank, equal to the
        one-device sweep's."""
        n = dist.get_world_size(group)
        blk = leading_block(-(-n_S // n) * n, n, dist.get_rank(group))

        def mine(x):
            return pad_leading_axis(x, n)[blk]
        ovr = tree_map(mine, ovr)
        if stores is not None:
            stores = stores._map(mine)
        if test_sets is not None:
            test_sets = (tree_map(mine, test_sets[0]), mine(test_sets[1]))
        carries, rows = self._grid_packed(ovr, stores, test_sets, carry, xs,
                                          blk.stop - blk.start)
        if n > 1:
            carries, rows = gather_leading(carries, group), \
                gather_leading(rows, group)
        return slice_leading_axis(carries, n_S), rows[:n_S]

    def _client_engine(self, mesh):
        """The engine whose rounds run split over ``mesh``'s clients axis:
        this one if it was built on a client mesh (``from_store(mesh=)``),
        else a twin kept for ``mesh`` that shares this engine's template,
        test split and params and holds views of this rank's block of the
        store, with graphs of its own."""
        if self._axis is not None:
            return self
        eng = self._client_twins.get(mesh)
        if eng is None:
            eng = copy.copy(self)
            eng._solver_tmpl = dict(self._solver_tmpl)
            eng._client_twins = {}
            eng._set_axis(_clients_group(mesh, self.K))
            eng._store = self._store._map(lambda x: x[eng._block])
            eng._reset_graphs()
            self._client_twins[mesh] = eng
        return eng

    def _on_device(self, x):
        return x.to(self.device) if isinstance(x, torch.Tensor) else \
            torch.as_tensor(np.asarray(x), device=self.device)

    def _grid_inputs(self, overrides, stores, test_sets):
        """A grid's inputs on the engine's device, checked against its
        geometry: (overrides, stores, test_sets, S)."""
        slots = sorted(k for k, v in self._solver_tmpl.items()
                       if isinstance(v, torch.Tensor))
        bad = sorted(set(overrides) - set(slots))
        if bad or not overrides:
            raise ValueError(f"overrides {sorted(overrides)}: a grid "
                             f"overrides one or more of the solver "
                             f"template's device entries {slots}")
        ovr = to_device({k: (v.detach().cpu().numpy()
                             if isinstance(v, torch.Tensor) else v)
                         for k, v in overrides.items()}, self.device)
        n_S = None
        for k, v in ovr.items():
            if v.ndim == 0:
                raise ValueError(f"override {k!r} has no scenario axis")
            n_S = v.shape[0] if n_S is None else n_S
            if v.shape[0] != n_S:
                raise ValueError(f"override {k!r} has scenario axis "
                                 f"{v.shape[0]}, expected {n_S}")
            want = tuple(self._solver_tmpl[k].shape)
            if tuple(v.shape[1:]) != want:
                raise ValueError(f"override {k!r} rows {tuple(v.shape[1:])},"
                                 f" expected {want}")
        if stores is not None:
            stores = stores.to(self.device)
            for d, x in zip(self._store.leaves(), stores.leaves()):
                if tuple(x.shape) != (n_S,) + tuple(d.shape):
                    raise ValueError(f"stores leaf {tuple(x.shape)}, "
                                     f"expected {(n_S,) + tuple(d.shape)}")
        if test_sets is not None:
            feats, labels = test_sets
            if sorted(feats) != sorted(self.mods):
                raise ValueError(f"test features {sorted(feats)}, expected "
                                 f"{sorted(self.mods)}")
            feats = {m: self._on_device(feats[m]) for m in sorted(feats)}
            labels = self._on_device(labels)
            if any(x.shape[:2] != labels.shape[:2] for x in feats.values()) \
                    or labels.ndim != 2 or labels.shape[0] != n_S:
                raise ValueError(f"test labels {tuple(labels.shape)}: "
                                 f"expected [{n_S}, n_test] with features "
                                 f"of the same leading axes")
            test_sets = (feats, labels)
        return ovr, stores, test_sets, n_S

    def _grid_row(self, overrides, s: int, stores=None, test_sets=None):
        """Row ``s`` of a grid's inputs on the engine's device: (override
        rows, store or None, test split or None), as
        ``_scan_one_scenario`` takes them."""
        ovr, stores, test_sets, _ = self._grid_inputs(overrides, stores,
                                                      test_sets)
        return ({k: v[s] for k, v in ovr.items()},
                None if stores is None else stores.row(s),
                None if test_sets is None else
                ({m: x[s] for m, x in test_sets[0].items()},
                 test_sets[1][s]))

    def _scan_one_scenario(self, overrides, store, test_set,
                           carry: FusedCarry, xs: RoundXs):
        """One scenario's whole experiment with the body run eagerly and
        the scenario passed as arguments (``_grid_row``; store None: the
        engine's), nothing swapped: the reference a grid's replays are
        held against.  (final carry, RoundAux with [R]-leading leaves)."""
        store = self._store if store is None else store
        auxs = []
        for i in range(xs.h.shape[0]):
            x = tree_row(xs, i)
            carry, aux = self._round_step(carry, self._local_xs(x), store,
                                          bool(x.eval_flag),
                                          overrides=overrides,
                                          test_set=test_set, axis=self._axis)
            auxs.append(aux)
        return carry, tree_map(lambda *a: torch.stack(a), *auxs)

    def _grid_test_buffers(self, test_sets):
        """Static test buffers at a grid's test shape, kept for the next
        grid of that shape; another shape drops the grid's eval graph,
        captured on the old buffers."""
        feats, labels = test_sets
        cur = self._grid_test
        if cur is None or any(
                cur[0][m].shape != feats[m].shape[1:]
                or cur[0][m].dtype != feats[m].dtype for m in feats) \
                or cur[1].shape != labels.shape[1:] \
                or cur[1].dtype != labels.dtype:
            self._grid_test = (
                {m: torch.empty(x.shape[1:], dtype=x.dtype,
                                device=self.device)
                 for m, x in feats.items()},
                torch.empty(labels.shape[1:], dtype=labels.dtype,
                            device=self.device))
            self._graphs.pop("grid", None)
        return self._grid_test

    def _swap_in(self, ovr, stores, test_sets, s: int):
        """Scenario ``s``'s rows into the static tensors the round reads:
        each a ``copy_`` into an address a graph captured, nothing
        rebound."""
        for k, v in ovr.items():
            self._solver_tmpl[k].copy_(v[s])
        if stores is not None:
            for d, x in zip(self._store.leaves(), stores.leaves()):
                d.copy_(x[s])
        if test_sets is not None:
            (tf, tl), (gf, gl) = test_sets, self._grid_test
            for m, x in gf.items():
                x.copy_(tf[m][s])
            gl.copy_(tl[s])

    def _grid_packed(self, ovr, stores, test_sets, carry: FusedCarry,
                     xs: RoundXs, n_S: int):
        """([S]-stacked final carries, packed aux rows [S, R, n]) of a
        grid, with the engine's template entries, store and static carry
        put back afterwards."""
        init = tree_map(lambda x: x.detach().clone(), carry)
        test = None if test_sets is None else \
            self._grid_test_buffers(test_sets)
        own = [self._solver_tmpl[k] for k in ovr]
        if stores is not None:
            own += self._store.leaves()
        if self._static_carry is not None:
            own += tree_leaves(self._static_carry)
        kept = [(t, t.clone()) for t in own]
        carries = rows = None
        try:
            for s in range(n_S):
                self._swap_in(ovr, stores, test_sets, s)
                c, r = self._scan_packed(init, xs, test)
                if carries is None:
                    carries = tree_map(
                        lambda x: x.new_empty((n_S,) + tuple(x.shape)), c)
                    rows = r.new_empty((n_S,) + tuple(r.shape))
                for d, x in zip(tree_leaves(carries), tree_leaves(c)):
                    d[s].copy_(x)
                rows[s].copy_(r)
        finally:
            for t, saved in kept:
                t.copy_(saved)
        return carries, rows
