"""The batched JCSBA solver in torch — the whole server-side decision layer
(immune search over antibodies × KKT bandwidth bisection × Theorem-1 bound)
on the experiment's device.  Counterpart of the JAX package's
``wireless/solver/jaxsolver.py``.

The population objective (the bisection stack, the energy and the bound
for every antibody row) is ``kernels.jcsba_solver.ops.population_objective``
— a CUDA kernel on a card, its plain version on the CPU; the immune search
around it (affinity, Hamming concentration, incentive, elites, clones,
mutants, the stable sorts) is a few hundred torch ops a round.  The solve
makes no host sync until the caller reads the decision back.

Random bits come in as tensors (``make_draws``' shapes), never from a
generator inside the solve, so tests can hand it the JAX package's own
``jax.random`` bits and hold it against ``jaxsolver`` decision for decision.

``solve_core`` is the tensor entry point — ``policies.JCSBAPolicy`` builds
its step on it; ``solve_round`` is the numpy-in/numpy-out per-solve call.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...device import resolve_device
from ...kernels.jcsba_solver import ops
from ...kernels.jcsba_solver.ref import rate
from .common import SolverHyper

__all__ = ["to_device", "rate", "make_draws", "solve_core", "read_back",
           "solve_round"]

_BOOL_KEYS = ("has", "bmin_ok")
_SCALAR_KEYS = ("B_max", "p_tx", "N0", "eta", "rho")


def to_device(data: dict, device) -> dict:
    """numpy solver-data dict (``common.build_solver_data``) → float32
    tensors on ``device`` (``has`` bool) in one host-to-device copy.  The
    fixed scalars (B_max, p_tx, N0, η, ρ) stay Python floats, rounded to
    float32; V becomes a 0-d float32 tensor, which the population kernel
    reads on the device, so a scenario grid can swap it under a captured
    round."""
    arrays = {k: np.asarray(v) for k, v in data.items()
              if k not in _SCALAR_KEYS}
    flat = np.concatenate([a.astype(np.float32).ravel()
                           for a in arrays.values()]) if arrays else \
        np.zeros(0, np.float32)
    buf = torch.from_numpy(flat).to(device)
    out, at = {}, 0
    for k, a in arrays.items():
        t = buf[at:at + a.size].view(a.shape)
        at += a.size
        out[k] = t > 0.5 if k in _BOOL_KEYS else t
    for k in _SCALAR_KEYS:
        if k in data:
            out[k] = float(np.float32(data[k]))
    return out


def make_draws(generator: torch.Generator, K: int, hp: SolverHyper,
               device=None):
    """All random bits of one solve, as bool tensors of the JAX package's
    ``make_draws`` shapes: init [S, K] ~ Bernoulli(0.5), mut [G, n_clones,
    K] ~ Bernoulli(z), fresh [G, n_fresh, K] ~ Bernoulli(0.5)."""
    device = generator.device if device is None else device

    def bern(p, shape):
        return torch.rand(shape, generator=generator, device=device) < p

    return (bern(0.5, (hp.S, K)), bern(hp.z, (hp.G, hp.n_clones, K)),
            bern(0.5, (hp.G, hp.n_fresh, K)))


def _affinity(vals, hp: SolverHyper):
    """Eq. 50 affinity: min-max normalised, sharpened; infeasible → 0."""
    finite = torch.isfinite(vals)
    jmax = torch.where(finite, vals, -math.inf).amax()
    jmin = torch.where(finite, vals, math.inf).amin()
    span = torch.clamp_min(jmax - jmin, 1e-12)
    base = torch.clamp_min((jmax - vals) / span, 0.0) + 1e-6
    aff = torch.where(finite, base ** hp.iota, 0.0)
    return torch.where(finite.any(), aff, torch.zeros_like(vals))


def _row(x, i):
    """x[i] for a 0-d index tensor on x's device, without a host sync."""
    return x.index_select(0, i.reshape(1))[0]


def solve_core(data: dict, seeds, draws, hp: SolverHyper):
    """One JCSBA solve: (a* [K] bool, J* 0-d f32, B* [K] f32) for one
    round's ``data`` (``to_device``'s dict), on its device.

    ``seeds`` [2, K] bool: warm-start antibody rows written over the first
    population rows (row 1 is conventionally the all-zeros antibody, so an
    empty schedule is always evaluated and J* is always finite).  ``draws``
    = (init, mut, fresh) as from ``make_draws``.

    Callers may inject a precomputed per-client bisection as
    ``data["bmin"]`` / ``data["bmin_ok"]``, as in the JAX package."""
    K = data["Q"].shape[0]
    args = ops.launch_args(data, hp)      # one struct for every launch
    if "bmin" in data:
        bmin, ok = data["bmin"], data["bmin_ok"]
    else:
        bmin, ok = ops.bmin(data["gamma"], data["h"], data["tau_rem"],
                            data["B_max"], data["p_tx"], data["N0"], hp,
                            args=args)

    def J_batch(A):
        return ops.population_objective(A.contiguous(), bmin, ok, data,
                                        hp, args=args)[0]

    def fold_best(pop, vals, best_a, best_J):
        i = torch.argmin(vals)                # first index, as jnp.argmin
        v = _row(vals, i)
        better = v < best_J
        return torch.where(better, _row(pop, i), best_a), \
            torch.where(better, v, best_J)

    init, mut, fresh = (torch.as_tensor(d, device=bmin.device).to(torch.bool)
                        for d in draws)
    seeds = torch.as_tensor(seeds, device=bmin.device).to(torch.bool)
    pop = init.clone()
    pop[0], pop[1] = seeds[0], seeds[1]

    # J is purely row-wise, so the population's values are carried across
    # generations and only new genotypes (clones/mutants + fresh rows) are
    # evaluated
    vals = J_batch(pop)
    best_a = torch.zeros(K, dtype=torch.bool, device=bmin.device)
    best_J = torch.full((), math.inf, dtype=torch.float32,
                        device=bmin.device)
    for g in range(hp.G):
        best_a, best_J = fold_best(pop, vals, best_a, best_J)
        aff = _affinity(vals, hp)
        ham = (pop[:, None, :] ^ pop[None, :, :]).sum(-1)
        con = (ham <= hp.dis).to(aff.dtype).mean(-1)          # Eq. 51-52
        inc = hp.eps1 * aff - hp.eps2 * con                   # Eq. 53
        elites = pop[torch.argsort(-inc, stable=True)[:hp.n_elite]]
        clones = elites.repeat_interleave(hp.mu, dim=0)       # μ-fold cloning
        mutants = clones ^ mut[g]
        cand = torch.cat([mutants, elites], dim=0)
        cand_vals = J_batch(cand)
        cand_aff = _affinity(cand_vals, hp)
        order = torch.argsort(-cand_aff, stable=True)[:hp.n_keep]
        pop = torch.cat([cand[order], fresh[g]], dim=0)
        vals = torch.cat([cand_vals[order], J_batch(fresh[g])])
    best_a, best_J = fold_best(pop, vals, best_a, best_J)     # final gen
    _, B, _ = ops.population_objective(best_a[None].contiguous(), bmin, ok,
                                       data, hp, want_B=True, args=args)
    return best_a, best_J, B[0]


def read_back(a, J, B):
    """(a [K] bool, J float, B [K] float64) on the host, in one copy."""
    out = torch.cat([a.to(torch.float32), J.reshape(1).to(torch.float32),
                     B.to(torch.float32)]).cpu().numpy()
    K = a.shape[0]
    return out[:K] > 0.5, float(out[K]), out[K + 1:].astype(np.float64)


def solve_round(data: dict, seeds: np.ndarray, draws, hp: SolverHyper,
                device="cuda"):
    """Host-facing per-round solve on ``device``: numpy in, numpy out —
    (a* [K] bool, J*, B* [K] float64)."""
    a, J, B = solve_core(to_device(data, resolve_device(device)), seeds,
                         draws, hp)
    return read_back(a, J, B)
