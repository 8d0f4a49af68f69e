"""Shared inputs for the port's solver, policy and runtime parity tests.

``jax_draw_source`` is a draw source for the port's schedulers that makes
the JAX package's own ``jax.random`` bits from a round's seed, as its
policies draw them inside their traced step (``repro/wireless/
policies.py``): JCSBA ``make_draws``; Random ``uniform(key, (K,))``;
Dropout ``split`` into a permutation key and ``dropout_draws``'s key.  With
it the port's decisions can be held equal to the JAX package's, round by
round.  ``setup``/``solver_data`` build one round's wireless context from
a seed with either package's modules."""
import jax
import numpy as np

from repro.core.aggregation import unified_weights as j_unified_weights
from repro.core.convergence import BoundState as JBound
from repro.wireless import cost as jcost
from repro.wireless.channel import Channel as JChannel
from repro.wireless.params import MODALITY_PROFILES as J_PROFILES
from repro.wireless.params import WirelessParams as JParams
from repro.wireless.policies import dropout_draws
from repro.wireless.solver import build_solver_data as j_build
from repro.wireless.solver.jaxsolver import make_draws
from repro_torch.core.aggregation import unified_weights
from repro_torch.core.convergence import BoundState
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
