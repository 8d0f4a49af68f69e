"""The port's Algorithm-1 loop (``repro_torch.fl.runtime``) against the JAX
package's ``MFLExperiment``, for every scheduler and JCSBA solver backend.

Both run on the same seed; both sides swap in a ``dropout=0.0`` adapter
(the port cannot replay ``jax.random``) and the port takes the JAX
package's initial params.  The port's schedulers get the JAX package's own
``jax.random`` bits through a draw source (``_torch_jax_parity``; the
``seq`` solver draws only from the shared numpy stream).  Participants,
failures and dropped modalities must be identical round by round, energy
agrees to 1e-9, global params and the test loss to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_jax_parity import pair
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.fl.runtime import parse_engine as jparse
from repro.wireless import bandwidth as jbw
from repro.wireless.channel import Channel as JChannel
from repro.wireless.params import WirelessParams as JParams
from repro_torch.convert import params_to_numpy
from repro_torch.core.trees import tree_leaves, tree_map
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.fl.runtime import parse_engine as tparse
from repro_torch.wireless import bandwidth as tbw
from repro_torch.wireless.channel import Channel as TChannel
from repro_torch.wireless.params import WirelessParams as TParams


@pytest.mark.parametrize("dataset,rounds,scheduler,engine,skw", [
    pytest.param("crema_d", 2, "jcsba", "batched:seq+pallas", None,
                 id="crema_d-2"),
    pytest.param("iemocap", 1, "jcsba", "batched:seq+pallas", None,
                 id="iemocap-1"),
    pytest.param("crema_d", 2, "jcsba", "batched:pallas", None,
                 id="crema_d-2-jcsba-jax"),
    pytest.param("crema_d", 2, "jcsba", "batched:np+pallas", None,
                 id="crema_d-2-jcsba-np"),
    # subsets smaller than K, so the draws and the cursor decide
    pytest.param("crema_d", 2, "random", "batched:pallas", {"n_sched": 2},
                 id="crema_d-2-random"),
    pytest.param("crema_d", 2, "round_robin", "batched:pallas",
                 {"n_sched": 3}, id="crema_d-2-round_robin"),
    pytest.param("crema_d", 2, "selection", "batched:pallas", None,
                 id="crema_d-2-selection"),
    # p_drop raised from 0.3 so that both rounds drop a modality
    pytest.param("crema_d", 2, "dropout", "batched:pallas",
                 {"n_sched": 2, "p_drop": 0.9}, id="crema_d-2-dropout"),
])
def test_experiment_matches_jax_round_by_round(dataset, rounds, scheduler,
                                               engine, skw):
    j, t = pair(dataset, engine, scheduler, skw, K=4, n_samples=160)
    for _ in range(rounds):
        rj, rt = j.run_round(), t.run_round()
        assert rt.participants == rj.participants
        assert rt.failures == rj.failures
        assert rt.dropped == rj.dropped
        assert rt.energy_total == pytest.approx(rj.energy_total, abs=1e-9)
        assert sorted(rt.metrics) == sorted(rj.metrics)
        assert rt.metrics["loss"] == pytest.approx(rj.metrics["loss"],
                                                   abs=1e-4)
        jp = jax.tree.leaves(jax.tree.map(np.asarray, j.global_params))
        tp = tree_leaves(params_to_numpy(t.global_params))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(t.model_dist, j.model_dist, rtol=1e-4,
                                   atol=1e-4)
        for m in t.all_mods:
            assert t.bound.zeta[m] == pytest.approx(j.bound.zeta[m],
                                                    rel=1e-4)
            np.testing.assert_allclose(t.bound.delta[m], j.bound.delta[m],
                                       rtol=1e-4)
    assert t.final_metrics().keys() == j.final_metrics().keys()


def test_round_robin_schedules_match_through_a_pool_tie():
    """Round-robin over 2 of 4 clients, in float64 on both sides.  In
    float32, round 1 has one CREMA-D image of client 2 with two outputs of
    its last convolution 1.5 ulp apart in one 5×5 pool window, which XLA's
    and torch's convolutions (another summation order) rank oppositely,
    so the max-pool routes that sample's gradient elsewhere and the conv
    weights end 1.4e-4 apart.  In float64 (``jax.enable_x64``; float64
    params, features and test split in both packages) the two outputs are
    no longer within rounding of each other: the schedules, failures and
    energies are identical and the training agrees to the file's 1e-4."""
    f64 = lambda x: jnp.asarray(x, jnp.float64)             # noqa: E731
    with jax.enable_x64(True):
        j, t = pair("crema_d", "batched:pallas", "round_robin",
                     {"n_sched": 2}, K=4, n_samples=160)
        j.global_params = jax.tree.map(f64, j.global_params)
        j.init_params = jax.tree.map(f64, j.init_params)
        feats, labels, smask = j._get_stacked()
        j._stacked_dev = ({m: f64(x) for m, x in feats.items()}, labels,
                          f64(smask))
        t.global_params = tree_map(torch.Tensor.double, t.global_params)
        t.init_params = tree_map(torch.Tensor.double, t.init_params)
        feats, labels, smask = t._get_stacked()
        t._stacked_dev = ({m: x.double() for m, x in feats.items()},
                          labels, smask.double())
        for e in (j, t):
            e.test_ds.features = {m: x.astype(np.float64) for m, x in
                                  e.test_ds.features.items()}
        for _ in range(2):
            rj, rt = j.run_round(), t.run_round()
            assert rt.participants == rj.participants
            assert rt.failures == rj.failures
            assert rt.energy_total == pytest.approx(rj.energy_total,
                                                    abs=1e-9)
            assert rt.metrics["loss"] == pytest.approx(rj.metrics["loss"],
                                                       abs=1e-4)
            jp = jax.tree.leaves(jax.tree.map(np.asarray, j.global_params))
            tp = tree_leaves(params_to_numpy(t.global_params))
            for a, b in zip(tp, jp):
                assert a.dtype == b.dtype == np.float64
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(t.model_dist, j.model_dist,
                                       rtol=1e-4, atol=1e-4)
            for m in t.all_mods:
                assert t.bound.zeta[m] == pytest.approx(j.bound.zeta[m],
                                                        rel=1e-4)
                np.testing.assert_allclose(t.bound.delta[m],
                                           j.bound.delta[m], rtol=1e-4)
    assert rt.participants == [2, 3]
    np.testing.assert_array_equal(t.scheduler.state()["next"],
                                  j.scheduler.state()["next"])


@pytest.mark.parametrize("spec", ["batched", "batched:seq+pallas",
                                  "seq:np", "fused:pallas+remat",
                                  "batched:pallas+seq"])
def test_parse_engine_matches_jax(spec):
    assert tparse(spec) == jparse(spec)


@pytest.mark.parametrize("spec", ["nope", "batched:bogus", "batched:np+seq"])
def test_parse_engine_rejects_like_jax(spec):
    for parse in (jparse, tparse):
        with pytest.raises(ValueError):
            parse(spec)


def test_numpy_copies_are_bit_identical():
    """Data, partition, channel and bandwidth copies match the JAX
    package's modules bit for bit on the same seed."""
    for name in ("crema_d", "iemocap"):
        dj = jsyn.DATASETS[name](seed=3, n=60)
        dt = tsyn.DATASETS[name](seed=3, n=60)
        np.testing.assert_array_equal(dj.labels, dt.labels)
        for m in dj.features:
            np.testing.assert_array_equal(dj.features[m], dt.features[m])
        cj = jpart.partition(dj, 5, 0.4, seed=1, dirichlet_alpha=0.5)
        ct = tpart.partition(dt, 5, 0.4, seed=1, dirichlet_alpha=0.5)
        assert [c.modalities for c in cj] == [c.modalities for c in ct]
        sj = jpart.stack_clients(cj, sorted(dj.features))
        st = tpart.stack_clients(ct, sorted(dt.features))
        np.testing.assert_array_equal(sj.sample_mask, st.sample_mask)
        for m in sj.features:
            np.testing.assert_array_equal(sj.features[m], st.features[m])
    hj = JChannel(JParams(K=5), np.random.default_rng(2)).draw()
    ht = TChannel(TParams(K=5), np.random.default_rng(2)).draw()
    np.testing.assert_array_equal(hj, ht)
    args = (np.full(5, 0.5), np.full(5, 1.2e6), hj, np.full(5, 8e-3))
    np.testing.assert_array_equal(jbw.allocate(*args, JParams(K=5)),
                                  tbw.allocate(*args, TParams(K=5)))
