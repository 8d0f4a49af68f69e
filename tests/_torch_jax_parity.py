"""Shared inputs for the port's solver, policy and runtime parity tests.

``jax_draw_source`` is a draw source for the port's schedulers that makes
the JAX package's own ``jax.random`` bits from a round's seed, as its
policies draw them inside their traced step (``repro/wireless/
policies.py``): JCSBA ``make_draws``; Random ``uniform(key, (K,))``;
Dropout ``split`` into a permutation key and ``dropout_draws``'s key.  With
it the port's decisions can be held equal to the JAX package's, round by
round.  ``setup``/``solver_data`` build one round's wireless context from
a seed with either package's modules; ``pair`` builds the same experiment
in both packages, and ``assert_round_match`` / ``assert_state_match`` hold
them together at the parity tolerances."""
import jax
import numpy as np

import pytest

from repro.core.aggregation import unified_weights as j_unified_weights
from repro.core.convergence import BoundState as JBound
from repro.fl.client import make_adapter as j_make_adapter
from repro.fl.runtime import MFLExperiment as JExperiment
from repro.fl.runtime import parse_engine as j_parse_engine
from repro.wireless import cost as jcost
from repro.wireless.channel import Channel as JChannel
from repro.wireless.params import MODALITY_PROFILES as J_PROFILES
from repro.wireless.params import WirelessParams as JParams
from repro.wireless.policies import dropout_draws
from repro.wireless.solver import build_solver_data as j_build
from repro.wireless.solver.jaxsolver import make_draws
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.aggregation import unified_weights
from repro_torch.core.convergence import BoundState
from repro_torch.core.trees import tree_leaves
from repro_torch.fl.client import make_adapter as t_make_adapter
from repro_torch.fl.runtime import MFLExperiment as TExperiment
from repro_torch.wireless import cost as tcost
from repro_torch.wireless.params import MODALITY_PROFILES, WirelessParams

MODS = ("audio", "image")


def jax_draw_source(policy, seed):
    key = jax.random.PRNGKey(np.uint32(seed))
    K = policy.K
    if policy.name == "jcsba":
        init, mut, fresh = make_draws(key, K, policy.hp)
        return {"init": np.array(init), "mut": np.array(mut),
                "fresh": np.array(fresh)}
    if policy.name == "random":
        return {"u": np.array(jax.random.uniform(key, (K,)))}
    if policy.name == "dropout":
        k_sub, k_drop = jax.random.split(key)
        u_drop, u_which = dropout_draws(k_drop, K)
        return {"perm": np.array(jax.random.permutation(k_sub, K)),
                "u_drop": np.array(u_drop), "u_which": np.array(u_which)}
    return {}


def setup(K, seed, tau_max=None, pkg="jax"):
    """(cost, params, bound, mods, rng) from the JAX package's modules or
    the port's copies, with the trackers moved off their symmetric init."""
    if pkg == "jax":
        Params, costs, uw, Bound = (JParams, jcost.client_costs,
                                    j_unified_weights, JBound)
        profiles = J_PROFILES
    else:
        Params, costs, uw, Bound = (WirelessParams, tcost.client_costs,
                                    unified_weights, BoundState)
        profiles = MODALITY_PROFILES
    params = Params(K=K, **({} if tau_max is None else {"tau_max": tau_max}))
    rng = np.random.default_rng(seed)
    mods = ([("audio", "image"), ("audio",), ("image",)] * (K // 3 + 1))[:K]
    sizes = [50] * K
    cc = costs(sizes, mods, profiles["crema_d"], params)
    bound = Bound(K, list(MODS), mods, uw(sizes, mods, list(MODS)), sizes)
    for m in bound.mods:
        bound.zeta[m] = float(rng.uniform(0.5, 2.0))
        bound.delta[m] = rng.uniform(0.1, 0.6, K)
    return cc, params, bound, mods, rng


def solver_data(K=6, seed=0, tau_max=None, V=1.0):
    """One round's numpy solver data (the JAX package's ``build_solver_data``)."""
    cc, params, bound, _, rng = setup(K, seed, tau_max)
    h = JChannel(params, rng).draw()
    return j_build(h, rng.uniform(0, 0.01, K), cc, params, bound, V)


def pair(dataset, engine, scheduler="jcsba", scheduler_kwargs=None,
         arch="lstm-cnn", wireless=None, **kw):
    """The same experiment in both packages on the CPU: ``dropout=0.0``
    adapters of the engine's loss backend on both sides, the port on the
    JAX package's initial params and ``jax.random`` bits; ``wireless``
    overrides fields of each package's ``WirelessParams``."""
    _, _, loss, remat, kernels, _ = j_parse_engine(engine)
    skw = dict(scheduler_kwargs or {})
    if wireless:
        K = kw.get("K", 10)
        kw_j = dict(kw, params=JParams(K=K, **wireless))
        kw = dict(kw, params=WirelessParams(K=K, **wireless))
    else:
        kw_j = kw
    j = JExperiment(dataset, engine=engine, scheduler=scheduler,
                    scheduler_kwargs=dict(skw), arch=arch, **kw_j)
    j.adapter = j_make_adapter(dataset, arch, dropout=0.0,
                               loss_backend=loss, remat=remat,
                               use_kernels=kernels)
    t = TExperiment(dataset, engine=engine, scheduler=scheduler,
                    scheduler_kwargs=dict(skw, draw_source=jax_draw_source),
                    arch=arch, device="cpu", **kw)
    t.adapter = t_make_adapter(dataset, arch, dropout=0.0,
                               loss_backend=loss, remat=remat,
                               use_kernels=kernels)
    t.global_params = params_from_numpy(
        jax.tree.map(np.asarray, j.global_params), "cpu")
    t.init_params = params_from_numpy(
        jax.tree.map(np.asarray, j.init_params), "cpu")
    return j, t


def assert_round_match(rj, rt, energy_rel=0.0):
    """Participants, failures and drops identical; energy within 1e-9
    (or ``energy_rel`` relative, for float32 accounting); the test loss
    within 1e-4."""
    assert rt.participants == rj.participants
    assert rt.failures == rj.failures
    assert rt.dropped == rj.dropped
    if energy_rel:
        assert rt.energy_total == pytest.approx(rj.energy_total,
                                                rel=energy_rel)
    else:
        assert rt.energy_total == pytest.approx(rj.energy_total, abs=1e-9)
    assert sorted(rt.metrics) == sorted(rj.metrics)
    for k in rj.metrics:
        assert rt.metrics[k] == pytest.approx(rj.metrics[k], abs=1e-4), k


def assert_state_match(j, t, tol=1e-4):
    """Global params, ζ, δ and model_dist within ``tol``."""
    jp = jax.tree.leaves(jax.tree.map(np.asarray, j.global_params))
    tp = tree_leaves(params_to_numpy(t.global_params))
    assert len(jp) == len(tp)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    np.testing.assert_allclose(t.model_dist, j.model_dist, rtol=tol,
                               atol=tol)
    for m in t.all_mods:
        assert t.bound.zeta[m] == pytest.approx(j.bound.zeta[m], rel=tol,
                                                abs=tol)
        np.testing.assert_allclose(t.bound.delta[m], j.bound.delta[m],
                                   rtol=tol, atol=tol)
