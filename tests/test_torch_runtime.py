"""The port's Algorithm-1 loop (``repro_torch.fl.runtime``) against the JAX
package's ``MFLExperiment(engine="batched:seq+pallas")``.

Both run on the same seed; both sides swap in a ``dropout=0.0`` adapter
(the port cannot replay ``jax.random``) and the port takes the JAX
package's initial params.  Participants and failures must be identical
round by round (the ``seq`` solver draws only from the shared numpy
stream), energy agrees to 1e-9, global params and the test loss to 1e-4.
"""
import jax
import numpy as np
import pytest

from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.fl.client import PaperModelAdapter as JAdapter
from repro.fl.runtime import MFLExperiment as JExperiment
from repro.fl.runtime import parse_engine as jparse
from repro.wireless import bandwidth as jbw
from repro.wireless.channel import Channel as JChannel
from repro.wireless.params import WirelessParams as JParams
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.trees import tree_leaves
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.fl.client import PaperModelAdapter as TAdapter
from repro_torch.fl.runtime import MFLExperiment as TExperiment
from repro_torch.fl.runtime import parse_engine as tparse
from repro_torch.wireless import bandwidth as tbw
from repro_torch.wireless.channel import Channel as TChannel
from repro_torch.wireless.params import WirelessParams as TParams


def _pair(dataset, **kw):
    j = JExperiment(dataset, engine="batched:seq+pallas", **kw)
    j.adapter = JAdapter(dataset, dropout=0.0, loss_backend="pallas")
    t = TExperiment(dataset, engine="batched:seq+pallas", device="cpu", **kw)
    t.adapter = TAdapter(dataset, dropout=0.0, loss_backend="pallas")
    t.global_params = params_from_numpy(
        jax.tree.map(np.asarray, j.global_params), "cpu")
    t.init_params = params_from_numpy(
        jax.tree.map(np.asarray, j.init_params), "cpu")
    return j, t


@pytest.mark.parametrize("dataset,rounds", [("crema_d", 2), ("iemocap", 1)])
def test_experiment_matches_jax_round_by_round(dataset, rounds):
    j, t = _pair(dataset, K=4, n_samples=160)
    for _ in range(rounds):
        rj, rt = j.run_round(), t.run_round()
        assert rt.participants == rj.participants
        assert rt.failures == rj.failures
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


@pytest.mark.parametrize("kw", [
    dict(engine="batched"),                     # solver jax
    dict(engine="batched:np"),
    dict(engine="seq:seq"),
    dict(engine="fused:seq"),
    dict(engine="batched:seq", scheduler="round_robin"),
    dict(engine="batched:seq", scheduler="random"),
    dict(engine="batched:seq", scheduler="selection"),
])
def test_unported_pieces_refuse(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TExperiment("crema_d", K=4, n_samples=80, device="cpu", **kw)


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
