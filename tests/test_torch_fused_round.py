"""The port's fused round (``engine="fused"``, ``fl/fused_round.py``)
against the JAX package's, and against the port's own host loops.

On the CPU the fused round runs its body eagerly (a card replays it as a
CUDA graph; the ``gpu`` tests in ``tests/test_torch_isolation.py`` hold the
replays against this body).  Against the JAX package, on its params and
``jax.random`` bits with ``dropout=0.0``: participants, failures and drops
identical round by round, energy within 1e-6 relative (float32 ``spent``
in both carries), params, ζ, δ and model_dist within 1e-4, stepwise and
through ``run_scanned``.  Also: an all-failure round equals the JAX
package's skip branch, the eval cadence inside a scan, ``run_scanned``
equal to stepwise, a checkpoint mid-experiment, ``fused:np``/``fused:seq``
refused, and JSON-safe records.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_jax_parity import assert_round_match, assert_state_match, pair
from repro.fl.runtime import MFLExperiment as JExperiment
from repro_torch.core.trees import tree_leaves
from repro_torch.data.partition import synthetic_population
from repro_torch.fl.client import make_adapter
from repro_torch.fl.fused_round import (FusedRoundEngine, draw_population_xs,
                                        draw_round_xs)
from repro_torch.fl.runtime import MFLExperiment, RoundRecord
from repro_torch.wireless.channel import Channel
from repro_torch.wireless.params import WirelessParams
from repro_torch.wireless.policies import make_policy

SMALL = dict(K=4, n_samples=160, seed=3)
FAST_JCSBA = {"immune_kwargs": {"S": 6, "G": 2}}
POLICIES = ("jcsba", "random", "round_robin", "selection", "dropout")

#: (dataset, engine, scheduler, scheduler_kwargs, eval_every)
JAX_CASES = {
    "crema_d-jcsba": ("crema_d", "fused:pallas", "jcsba", FAST_JCSBA, 1),
    "iemocap-dropout": ("iemocap", "fused", "dropout",
                        {"n_sched": 2, "p_drop": 0.9}, 2),
}


def _jax_pair(case):
    dataset, engine, scheduler, skw, ee = JAX_CASES[case]
    return pair(dataset, engine, scheduler, skw, eval_every=ee, **SMALL)


def _assert_carry_match(j, t):
    assert_state_match(j, t)
    np.testing.assert_allclose(t.queues.Q, j.queues.Q, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(t.queues.spent, j.queues.spent, rtol=1e-6,
                               atol=1e-9)
    for m in t.all_mods:
        np.testing.assert_allclose(t.last_weights[m], j.last_weights[m],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_fused_matches_jax_stepwise(case):
    j, t = _jax_pair(case)
    for _ in range(3):
        assert_round_match(j.run_round(), t.run_round(), energy_rel=1e-6)
        _assert_carry_match(j, t)
    assert any(r.participants for r in t.history)
    if case == "iemocap-dropout":
        assert any(r.dropped for r in t.history)


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_fused_matches_jax_scanned(case):
    j, t = _jax_pair(case)
    for rj, rt in zip(j.run_scanned(3), t.run_scanned(3)):
        assert_round_match(rj, rt, energy_rel=1e-6)
    _assert_carry_match(j, t)
    assert [bool(r.metrics) for r in t.history] == \
        [bool(r.metrics) for r in j.history]


def test_all_failure_round_equals_the_jax_skip_branch():
    """A latency budget no client meets: every scheduled client fails, the
    port's unconditional cohort step leaves the globals exactly as they
    were — what the JAX body's skip branch returns — and the eval runs."""
    j, t = pair("crema_d", "fused", "round_robin", {"n_sched": 3},
                wireless={"tau_max": 1e-6}, eval_every=1, **SMALL)
    p0 = [x.clone() for x in tree_leaves(t.global_params)]
    rj, rt = j.run_round(), t.run_round()
    assert rt.participants == [] and rt.failures == [0, 1, 2]
    assert_round_match(rj, rt, energy_rel=1e-6)
    for a, b in zip(p0, tree_leaves(t.global_params)):
        assert torch.equal(a, b)
    _assert_carry_match(j, t)
    host = t.adapter.evaluate(t.global_params, t.test_ds)
    for k, v in host.items():
        assert rt.metrics[k] == pytest.approx(v, abs=1e-6)


@pytest.mark.parametrize("policy", POLICIES)
def test_fused_matches_batched_host_loop(policy):
    kw = dict(dataset="iemocap", scheduler=policy, eval_every=100,
              device="cpu", scheduler_kwargs=(FAST_JCSBA if policy == "jcsba"
                                              else None), **SMALL)
    host = MFLExperiment(engine="batched:pallas", **kw)
    fus = MFLExperiment(engine="fused:pallas", **kw)
    host.run(3)
    fus.run(3)
    _assert_host_match(host, fus)


def test_fused_matches_seq_host_loop():
    kw = dict(dataset="crema_d", scheduler="jcsba", eval_every=100,
              device="cpu", scheduler_kwargs=FAST_JCSBA, **SMALL)
    host = MFLExperiment(engine="seq:pallas", **kw)
    fus = MFLExperiment(engine="fused:pallas", **kw)
    host.run(3)
    fus.run(3)
    _assert_host_match(host, fus)


def _assert_host_match(host, fus):
    for ra, rb in zip(host.history, fus.history):
        assert ra.participants == rb.participants
        assert ra.failures == rb.failures
        assert ra.dropped == rb.dropped
    for m in host.all_mods:
        np.testing.assert_allclose(host.last_weights[m],
                                   fus.last_weights[m], atol=1e-6)
        assert host.bound.zeta[m] == pytest.approx(fus.bound.zeta[m],
                                                   abs=1e-4)
        np.testing.assert_allclose(host.bound.delta[m], fus.bound.delta[m],
                                   atol=1e-4)
    for a, b in zip(tree_leaves(host.global_params),
                    tree_leaves(fus.global_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    np.testing.assert_allclose(host.queues.Q, fus.queues.Q, rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(host.queues.spent, fus.queues.spent,
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(host.model_dist, fus.model_dist, atol=1e-4)


def test_eval_cadence_inside_scan():
    """One scan with eval_every=2: metrics exactly on the grid rounds,
    finite, the last equal to the host eval of the final params."""
    fus = MFLExperiment("iemocap", engine="fused", scheduler="random",
                        eval_every=2, device="cpu", **SMALL)
    fus.run_scanned(5)
    assert [bool(r.metrics) for r in fus.history] == \
        [True, False, True, False, True]
    for r in fus.history:
        assert all(np.isfinite(v) for v in r.metrics.values())
    host = fus.adapter.evaluate(fus._carry.params, fus.test_ds)
    for k, v in host.items():
        assert fus.history[-1].metrics[k] == pytest.approx(v, abs=1e-6)


def _fused(**kw):
    return MFLExperiment("iemocap", scheduler="jcsba", engine="fused",
                         eval_every=3, device="cpu",
                         scheduler_kwargs=FAST_JCSBA, **dict(SMALL, **kw))


def test_run_scanned_matches_stepwise_exactly():
    """R rounds of ``run_scanned`` are R ``run_round`` calls: the same
    body on the same inputs drawn in the same order, bit for bit."""
    step, scan = _fused(), _fused()
    step.run(3)
    scan.run_scanned(3)
    for a, b in zip(tree_leaves(step._carry), tree_leaves(scan._carry)):
        assert torch.equal(a, b)
    for ra, rb in zip(step.history, scan.history):
        assert (ra.participants, ra.failures, ra.energy_total,
                ra.metrics) == (rb.participants, rb.failures,
                                rb.energy_total, rb.metrics)


def test_fused_checkpoint_mid_experiment(tmp_path):
    exp = _fused()
    exp.run_scanned(3)
    exp.save(str(tmp_path))
    twin = _fused()
    assert twin.restore(str(tmp_path)) == 3
    for a, b in zip(tree_leaves(exp._carry), tree_leaves(twin._carry)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(exp._carry.policy["warm_a"].numpy(),
                                  twin.scheduler.state()["warm_a"])
    twin.run_scanned(2)
    assert twin._round == 5 and len(twin.history) == 2


@pytest.mark.parametrize("engine", ["fused:np", "fused:seq"])
def test_fused_requires_a_policy_on_tensors(engine):
    """JCSBA's np/seq parity backends run on the host only: both packages
    refuse them for the fused loop."""
    with pytest.raises(ValueError):
        JExperiment("iemocap", scheduler="jcsba", engine=engine)
    with pytest.raises(ValueError):
        MFLExperiment("iemocap", scheduler="jcsba", engine=engine,
                      device="cpu")


def test_draw_round_xs_eval_every_deprecated():
    exp = MFLExperiment("iemocap", engine="fused", scheduler="random",
                        eval_every=2, device="cpu", **SMALL)
    with pytest.warns(DeprecationWarning):
        xs = draw_round_xs(exp, 4, eval_every=3)
    np.testing.assert_array_equal(xs.eval_flag.numpy(),
                                  [True, False, False, True])
    xs2 = draw_round_xs(exp, 4)
    np.testing.assert_array_equal(xs2.eval_flag.numpy(),
                                  [True, False, True, False])
    assert xs2.draws["u"].shape == (4, 4)


def test_fused_records_are_json_safe(tmp_path):
    fus = MFLExperiment("iemocap", engine="fused", scheduler="round_robin",
                        device="cpu", **SMALL)
    rec = fus.run_round()
    blob = json.dumps(dataclasses.asdict(rec))
    assert isinstance(rec.energy_total, float) and "round" in blob
    assert all(isinstance(p, int) for p in rec.participants)
    rec2 = RoundRecord.make(torch.tensor(3), torch.tensor([1, 2]), [],
                            torch.tensor(0.5), {"loss": torch.tensor(1.0)},
                            0.0)
    json.dumps(dataclasses.asdict(rec2))
    assert rec2.participants == [1, 2] and rec2.metrics["loss"] == 1.0
    fus.save(str(tmp_path))
    manifest = json.load(open(str(tmp_path / "ckpt_00000001.json")))
    assert all(isinstance(v, float)
               for v in manifest["metadata"]["zeta"].values())


def test_engine_from_store_runs_a_population():
    """``from_store`` on a synthetic population (no MFLExperiment): zero
    cost vectors, so every scheduled client participates; rounds off the
    cadence carry NaN metrics; the cohort is the policy's n_sched."""
    K = 12
    store = synthetic_population(K, 8, {"audio": (32, 11),
                                        "image": (32, 32, 3)}, 6, 0.3,
                                 seed=1)
    params = WirelessParams(K=K)
    pol = make_policy("random", K, n_sched=3)
    eng = FusedRoundEngine.from_store(store, params, pol,
                                      make_adapter("crema_d", dropout=0.0),
                                      device="cpu")
    rng = np.random.default_rng(0)
    xs = draw_population_xs(Channel(params, rng), rng, K, 3, eval_every=2,
                            policy=pol, device="cpu")
    carry, aux, wall = eng.run(eng.fresh_carry(), xs, scanned=True)
    assert wall > 0 and aux.a.shape == (3, K)
    np.testing.assert_array_equal(aux.ok, aux.a)
    assert (aux.a.sum(1) == 3).all()
    np.testing.assert_array_equal(aux.eval_mask, [True, False, True])
    assert np.isnan(aux.metrics["loss"][1])
    assert np.isfinite(aux.metrics["loss"][[0, 2]]).all()
    assert all(torch.isfinite(x).all()
               for x in tree_leaves(eng.round_params(carry)))
