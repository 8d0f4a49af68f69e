"""The port's ``seq`` loop and checkpoints against the JAX package's.

* ``seq`` round by round against the JAX package's ``seq`` (JCSBA on the
  host search, round-robin on the fusion kernel's plain version, the
  dropout baseline), on the JAX package's params and ``jax.random`` bits
  with ``dropout=0.0``: participants, failures and drops identical, energy
  within 1e-9, params, ζ, δ and model_dist within 1e-4;
* ``seq`` against the port's ``batched`` loop with dropout on, ragged
  shards included (``tests/test_batched_equivalence.py``): the same
  schedules, the Eq. 12 weights exactly, params within 1e-5;
* the sequential aggregation functions and ``param_bits`` against the JAX
  package's;
* checkpoints across the two packages both ways, resume, the policy state
  of every policy, and the legacy ``warm_a`` blob.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_jax_parity import assert_round_match, assert_state_match, pair
from repro.core import aggregation as jagg
from repro.models import paper_models as jpm
from repro_torch.checkpoint import (latest_checkpoint, load_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import aggregation as agg
from repro_torch.core.trees import tree_leaves
from repro_torch.fl.runtime import MFLExperiment
from repro_torch.models import paper_models as pm

SMALL = dict(K=4, n_samples=160)
FAST_JCSBA = {"immune_kwargs": {"S": 6, "G": 2}}


@pytest.mark.parametrize("dataset,engine,scheduler,skw", [
    pytest.param("crema_d", "seq:seq", "jcsba", None, id="jcsba-seq:seq"),
    pytest.param("crema_d", "seq:pallas", "round_robin", {"n_sched": 3},
                 id="round_robin-pallas"),
    pytest.param("iemocap", "seq", "dropout",
                 {"n_sched": 3, "p_drop": 0.9}, id="dropout-iemocap"),
])
def test_seq_matches_jax_round_by_round(dataset, engine, scheduler, skw):
    j, t = pair(dataset, engine, scheduler, skw, **SMALL)
    dropped = 0
    for _ in range(2):
        rj, rt = j.run_round(), t.run_round()
        assert_round_match(rj, rt)
        assert_state_match(j, t)
        dropped += sum(len(v) for v in rt.dropped.values())
        for m in t.all_mods:
            np.testing.assert_array_equal(t.last_weights[m],
                                          j.last_weights[m])
    if scheduler == "dropout":
        assert dropped          # p_drop 0.9: the drop path ran


def _twin(dataset, scheduler, rounds, n_samples, **kw):
    cfg = dict(dataset=dataset, scheduler=scheduler, n_samples=n_samples,
               seed=3, eval_every=100, device="cpu", K=5, **kw)
    seq = MFLExperiment(engine="seq:pallas", **cfg)
    bat = MFLExperiment(engine="batched:pallas", **cfg)
    seq.run(rounds)
    bat.run(rounds)
    return seq, bat


@pytest.mark.parametrize("dataset,scheduler,kw", [
    pytest.param("crema_d", "round_robin", {}, id="round_robin-crema"),
    pytest.param("iemocap", "dropout", {"scheduler_kwargs": {"p_drop": 0.9}},
                 id="dropout-iemocap"),
    pytest.param("crema_d", "random", {"scheduler_kwargs": {"n_sched": 5}},
                 id="random-failures"),
])
def test_seq_matches_batched_with_dropout_on(dataset, scheduler, kw):
    """Dropout 0.1 in both loops: sample i's mask depends only on the
    client's seed and i, so the padded stack draws the same masks.  173
    samples give ragged shards (139 train samples over five clients: four
    of 28, one of 27)."""
    seq, bat = _twin(dataset, scheduler, 3, 173, **kw)
    assert seq.adapter.dropout == 0.1
    sizes = {c.size for c in seq.clients}
    assert len(sizes) > 1                       # ragged
    for ra, rb in zip(seq.history, bat.history):
        assert ra.participants == rb.participants
        assert ra.failures == rb.failures
        assert ra.dropped == rb.dropped
    if scheduler == "random":
        assert any(r.failures for r in seq.history)
    for m in seq.all_mods:
        np.testing.assert_allclose(seq.last_weights[m], bat.last_weights[m],
                                   atol=1e-12)
        assert seq.bound.zeta[m] == pytest.approx(bat.bound.zeta[m],
                                                  abs=1e-4)
        np.testing.assert_allclose(seq.bound.delta[m], bat.bound.delta[m],
                                   atol=1e-4)
    for a, b in zip(tree_leaves(seq.global_params),
                    tree_leaves(bat.global_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    np.testing.assert_allclose(seq.model_dist, bat.model_dist, atol=1e-4)


# ---------------------------------------------------------------------------
# the sequential aggregation, param_bits
# ---------------------------------------------------------------------------
def test_sequential_aggregation_matches_jax():
    rng = np.random.default_rng(0)
    K, mods = 5, ("audio", "image")
    sizes = [30, 12, 25, 40, 8]
    owners = [("audio", "image"), ("audio",), ("image",), ("audio", "image"),
              ("image",)]
    for part in ([], [1], [0, 2, 3], list(range(K))):
        for m, w in jagg.participated_weights(sizes, owners, part,
                                              mods).items():
            np.testing.assert_array_equal(
                agg.participated_weights(sizes, owners, part, mods)[m], w)
    glob = {m: {"w": rng.standard_normal((3, 2)).astype(np.float32),
                "b": rng.standard_normal(2).astype(np.float32)}
            for m in mods}
    uploads = [None] * K
    for k in (0, 2, 3):
        uploads[k] = {m: {"w": rng.standard_normal((3, 2)).astype(np.float32),
                          "b": rng.standard_normal(2).astype(np.float32)}
                      for m in owners[k] if not (k == 3 and m == "image")}
    wj = jagg.weights_from_uploads(sizes, uploads, mods)
    wt = agg.weights_from_uploads(sizes, uploads, mods)
    for m in mods:
        np.testing.assert_array_equal(wt[m], wj[m])
    tu = [None if u is None else params_from_numpy(u, "cpu")
          for u in uploads]
    for got, want in ((agg.aggregate(params_from_numpy(glob, "cpu"), tu, wt),
                       jagg.aggregate(glob, uploads, wj)),
                      (agg.aggregate_gradients(tu, wt),
                       jagg.aggregate_gradients(uploads, wj))):
        assert sorted(got) == sorted(want)
        for a, b in zip(tree_leaves(params_to_numpy(got)),
                        jax.tree.leaves(jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_param_bits_matches_table2_order():
    """The LSTM/CNN sizes are of the paper's l_m order (562400 / 557056
    bits at fp32) and equal the JAX package's counts."""
    crema = pm.init_crema_model(torch.Generator().manual_seed(0))
    jcrema = jpm.init_crema_model(jax.random.key(0))
    for m in ("audio", "image"):
        bits = pm.param_bits(crema[m])
        assert 1e5 < bits < 5e6
        assert bits == jpm.param_bits(jcrema[m])
    assert pm.param_bits(crema["audio"], 16) * 2 == pm.param_bits(
        crema["audio"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _leaves(exp):
    """An experiment's global params as numpy leaves, either package."""
    if isinstance(exp, MFLExperiment):
        return tree_leaves(params_to_numpy(exp.global_params))
    return jax.tree.leaves(jax.tree.map(np.asarray, exp.global_params))


def _assert_restored(src, dst):
    for a, b in zip(_leaves(src), _leaves(dst)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dst.queues.Q, src.queues.Q)
    np.testing.assert_array_equal(dst.queues.spent, src.queues.spent)
    assert dst.queues.t == src.queues.t
    np.testing.assert_array_equal(dst.model_dist, src.model_dist)
    for m in src.all_mods:
        assert dst.bound.zeta[m] == src.bound.zeta[m]
        np.testing.assert_array_equal(dst.bound.delta[m], src.bound.delta[m])
    a_state, b_state = src.scheduler.state(), dst.scheduler.state()
    assert sorted(a_state) == sorted(b_state)
    for k in a_state:
        assert np.asarray(a_state[k]).dtype == np.asarray(b_state[k]).dtype
        np.testing.assert_array_equal(a_state[k], b_state[k])


@pytest.mark.parametrize("scheduler,skw", [
    ("jcsba", FAST_JCSBA), ("round_robin", {"n_sched": 3})])
def test_jax_checkpoint_restores_in_port(tmp_path, scheduler, skw):
    j, t = pair("crema_d", "batched", scheduler, skw, **SMALL)
    j.run(2)
    j.save(str(tmp_path))
    assert t.restore(str(tmp_path)) == 2
    _assert_restored(j, t)
    # from the restored state, on one fresh stream each, both go on alike
    for exp in (j, t):
        exp.rng = exp.channel.rng = exp.scheduler.rng = \
            np.random.default_rng(11)
    assert_round_match(j.run_round(), t.run_round())
    assert_state_match(j, t)


@pytest.mark.parametrize("scheduler,skw", [
    ("jcsba", FAST_JCSBA), ("round_robin", {"n_sched": 3})])
def test_port_checkpoint_restores_in_jax(tmp_path, scheduler, skw):
    j, t = pair("crema_d", "batched", scheduler, skw, **SMALL)
    t.run(2)
    t.save(str(tmp_path))
    assert j.restore(str(tmp_path)) == 2
    _assert_restored(t, j)


def test_checkpoint_tree_layout(tmp_path):
    """Keys are /-joined sorted dict paths, lists keyed #i, tensors saved as
    numpy; the latest step is found."""
    tree = {"b": torch.arange(3.0), "a": {"y": np.int32(4), "x": [1.5, 2]},
            "none": None}
    save_checkpoint(str(tmp_path), tree, step=3, metadata={"k": 1})
    fn = save_checkpoint(str(tmp_path), tree, step=12)
    assert latest_checkpoint(str(tmp_path)) == fn
    back, man = load_checkpoint(str(tmp_path), step=3)
    assert man["keys"] == ["a/x/#0", "a/x/#1", "a/y", "b"]
    assert man["metadata"] == {"k": 1} and man["step"] == 3
    np.testing.assert_array_equal(back["b"], [0.0, 1.0, 2.0])
    assert back["a"]["y"].dtype == np.int32 and back["a"]["x"]["#1"] == 2
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_checkpoint_resume_bitexact(tmp_path):
    """Save at round 4, restore into a twin: params and queues exact; the
    twin keeps running (``tests/test_fl_features.py``)."""
    cfg = dict(dataset="crema_d", scheduler="round_robin", n_samples=200,
               seed=7, eval_every=100, device="cpu", engine="batched:pallas")
    exp = MFLExperiment(**cfg)
    exp.run(4)
    exp.save(str(tmp_path))
    twin = MFLExperiment(**cfg)
    assert twin.restore(str(tmp_path)) == 4
    np.testing.assert_array_equal(exp.queues.Q, twin.queues.Q)
    for a, b in zip(tree_leaves(exp.global_params),
                    tree_leaves(twin.global_params)):
        assert torch.equal(a, b)
    twin.run(2)
    assert twin._round == 6


@pytest.mark.parametrize("policy", ["jcsba", "random", "round_robin",
                                    "selection", "dropout"])
def test_policy_state_roundtrips_through_checkpoint(tmp_path, policy):
    cfg = dict(dataset="iemocap", scheduler=policy, seed=7, eval_every=100,
               engine="fused", device="cpu",
               scheduler_kwargs=FAST_JCSBA if policy == "jcsba" else None,
               **SMALL)
    exp = MFLExperiment(**cfg)
    exp.run(3)
    exp.save(str(tmp_path))
    twin = MFLExperiment(**cfg)
    assert twin.restore(str(tmp_path)) == 3
    a_state, b_state = exp.scheduler.state(), twin.scheduler.state()
    assert sorted(a_state) == sorted(b_state)
    for k in a_state:
        assert a_state[k].dtype == b_state[k].dtype
        np.testing.assert_array_equal(a_state[k], b_state[k])
    # the rebuilt fused carry starts from the restored policy state
    for k in exp._carry.policy:
        assert torch.equal(exp._carry.policy[k], twin._carry.policy[k])
    twin.run(1)
    assert twin._round == 4


def test_legacy_warm_a_checkpoint_restores_with_warning(tmp_path):
    cfg = dict(dataset="iemocap", scheduler="jcsba", seed=4,
               eval_every=10 ** 9, device="cpu", scheduler_kwargs=FAST_JCSBA,
               **SMALL)
    exp = MFLExperiment(**cfg)
    exp.run(2)
    pol = exp.scheduler.state()
    # a checkpoint from before the policy layer: the warm start as a
    # top-level blob
    state = {"global_params": exp.global_params, "queues_Q": exp.queues.Q,
             "queues_spent": exp.queues.spent,
             "delta": {m: exp.bound.delta[m] for m in exp.all_mods},
             "model_dist": exp.model_dist, "warm_a": pol["warm_a"]}
    meta = {"round": exp._round, "queues_t": exp.queues.t,
            "zeta": {m: float(exp.bound.zeta[m]) for m in exp.all_mods}}
    save_checkpoint(str(tmp_path), state, step=exp._round, metadata=meta)
    twin = MFLExperiment(**cfg)
    with pytest.warns(DeprecationWarning, match="warm_a"):
        assert twin.restore(str(tmp_path)) == 2
    np.testing.assert_array_equal(twin.scheduler.state()["warm_a"],
                                  pol["warm_a"])
    # a fresh save writes the policy/ format: restoring it is silent
    twin.save(str(tmp_path / "new"))
    third = MFLExperiment(**cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        assert third.restore(str(tmp_path / "new")) == 2

