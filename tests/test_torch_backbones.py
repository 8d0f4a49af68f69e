"""The port's transformer/SSD backbone path against the JAX package's.

Each module that holds a kernel, and the whole training path, on the same
numpy inputs with the JAX package's params carried across by
``params_from_numpy``; dropout 0.0 on both sides (the port cannot replay
``jax.random``).  The JAX side reaches its Pallas kernels in interpret
mode; the port's CPU path runs the kernels' plain versions.  Tolerances
(float32): logits 1e-5 and gradients 5e-6, as tests/test_backbones.py holds
the JAX kernel path to its plain path; the cohort step 1e-4 and the
experiment 1e-4, as tests/test_torch_client.py / test_torch_runtime.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from repro.core import fusion as jfusion
from repro.fl.client import make_adapter as jmake_adapter
from repro.fl.runtime import MFLExperiment as JExperiment
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core import fusion as tfusion
from repro_torch.core.trees import tree_leaves, tree_map
from repro_torch.fl.client import BackboneAdapter
from repro_torch.fl.client import make_adapter as tmake_adapter
from repro_torch.fl.runtime import MFLExperiment as TExperiment
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

ARCHS = ("transformer", "ssd")
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(dataset, arch, seed=0):
    return _np(jmake_adapter(dataset, arch).init_global(
        jax.random.key(seed)))


def _iemocap_batch(seed=0, B=4):
    rng = np.random.default_rng(seed)
    feats = {"audio": rng.standard_normal((B, 32, 11)).astype(np.float32),
             "text": rng.standard_normal((B, 24, 100)).astype(np.float32)}
    return feats, rng.integers(0, 10, B).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_cross_in_jax_leaf_order(arch):
    """The encoder trees (nested blocks/l0/mixer/... with the leading
    n_blocks axis) cross both ways with the JAX package's names, shapes and
    ``jax.tree.leaves`` order, and the port builds the same structure."""
    jp = _jax_params("crema_d", arch)
    tp = params_from_numpy(jp, "cpu")
    assert jax.tree.structure(params_to_numpy(tp)) == jax.tree.structure(jp)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), b)
    own = BackboneAdapter("crema_d", arch=arch).init_global(
        torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(params_to_numpy(own)) == jax.tree.structure(jp)
    assert [tuple(x.shape) for x in tree_leaves(own)] == \
        [x.shape for x in jax.tree.leaves(jp)]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_encoder_logits_and_loss_grads_match_jax(arch, use_kernels):
    """``encoder_apply`` logits and the gradients of ``multimodal_loss``
    per arch, plain path and kernel path, against the JAX adapter."""
    feats, labels = _iemocap_batch()
    ja = jmake_adapter("iemocap", arch, use_kernels=use_kernels, dropout=0.0)
    gp = ja.init_global(jax.random.key(0))

    def jloss(p):
        lg = ja.modal_logits(p, {m: jnp.asarray(x) for m, x in feats.items()},
                             dropout_rng=jax.random.key(3))
        total, _ = jfusion.multimodal_loss(lg, jnp.asarray(labels),
                                           ja.v_weights)
        return total, lg

    (jtot, jlg), jgrads = jax.value_and_grad(jloss, has_aux=True)(gp)

    ta = tmake_adapter("iemocap", arch, use_kernels=use_kernels, dropout=0.0)
    tp = tree_map(lambda x: x[None].requires_grad_(),
                  params_from_numpy(_np(gp), "cpu"))
    tlg = ta.modal_logits(tp, {m: torch.as_tensor(x)[None]
                               for m, x in feats.items()},
                          dropout_seeds=torch.tensor([3]))
    ttot, _ = tfusion.multimodal_loss({m: x[0] for m, x in tlg.items()},
                                      torch.as_tensor(labels), ta.v_weights)
    tgrads = torch.autograd.grad(ttot, tree_leaves(tp))

    for m in feats:
        np.testing.assert_allclose(tlg[m][0].detach().numpy(),
                                   np.asarray(jlg[m]), rtol=1e-5, atol=1e-5)
    assert float(ttot.detach()) == pytest.approx(float(jtot), abs=1e-5)
    for a, b in zip(tgrads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-5,
                                   atol=5e-6)
    # the port's eval path: one model as a cohort of one, no dropout
    ev = ta.eval_logits(params_from_numpy(_np(gp), "cpu"),
                        {m: torch.as_tensor(x) for m, x in feats.items()})
    for m in feats:
        np.testing.assert_allclose(ev[m].numpy(), np.asarray(jlg[m]),
                                   rtol=1e-5, atol=1e-5)


def _cohort(K=3, N=6):
    rng = np.random.default_rng(0)
    feats = {"audio": rng.normal(size=(K, N, 32, 11)).astype(np.float32),
             "text": rng.normal(size=(K, N, 24, 100)).astype(np.float32)}
    labels = rng.integers(0, 10, (K, N)).astype(np.int32)
    smask = np.ones((K, N), np.float32)
    smask[1, 4:] = 0.0                                  # padded client shard
    avail = {"audio": np.array([1, 1, 0], np.float32),  # client 2 unscheduled
             "text": np.array([1, 0, 0], np.float32)}   # client 1: audio only
    seeds = np.array([5, 7, 11], np.uint32)
    return feats, labels, smask, avail, seeds


def _t_cohort_args(params, init, feats, labels, smask, avail, seeds):
    return (params_from_numpy(params, "cpu"), params_from_numpy(init, "cpu"),
            {m: torch.as_tensor(x) for m, x in feats.items()},
            torch.as_tensor(labels), torch.as_tensor(smask),
            {m: torch.as_tensor(a) for m, a in avail.items()},
            torch.as_tensor(seeds.astype(np.int64)))


@pytest.mark.parametrize("arch", ARCHS)
def test_cohort_step_matches_jax(arch):
    """The whole-cohort BGD step over K=3 (kernel loss and kernel mixers on
    both sides) against the JAX ``cohort_step``."""
    feats, labels, smask, avail, seeds = _cohort()
    params = _jax_params("iemocap", arch, 0)
    init = _jax_params("iemocap", arch, 1)
    mods = tuple(sorted(feats))
    ja = jmake_adapter("iemocap", arch, use_kernels=True, dropout=0.0,
                       loss_backend="pallas")
    jnew, jgrads, jtot, jdist = jax.jit(ja.cohort_step(mods))(
        *(jax.tree.map(jnp.asarray, t) for t in (params, init, feats)),
        jnp.asarray(labels), jnp.asarray(smask),
        {m: jnp.asarray(a) for m, a in avail.items()}, jnp.asarray(seeds))

    ta = tmake_adapter("iemocap", arch, use_kernels=True, dropout=0.0,
                       loss_backend="pallas")
    tnew, tgrads, ttot, tdist = ta.cohort_step(*_t_cohort_args(
        params, init, feats, labels, smask, avail, seeds))

    np.testing.assert_allclose(ttot.numpy(), jtot, rtol=1e-5, atol=1e-5)
    for m in mods:
        np.testing.assert_allclose(tdist[m].numpy(), jdist[m], **TOL)
        for got, want in ((tnew, jnew), (tgrads, jgrads)):
            for a, b in zip(tree_leaves(got[m]), jax.tree.leaves(want[m])):
                np.testing.assert_allclose(a.numpy(), b, **TOL)
    # the unscheduled client: gradient exactly zero
    for m in mods:
        assert all(bool((g[2] == 0).all()) for g in tree_leaves(tgrads[m]))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_no_remat(arch):
    """``remat`` checkpoints the cohort forward and every block: the same
    step, recomputed backward, within 1e-6."""
    feats, labels, smask, avail, seeds = _cohort()
    args = _t_cohort_args(_jax_params("iemocap", arch, 0),
                          _jax_params("iemocap", arch, 1), feats, labels,
                          smask, avail, seeds)
    outs = [tmake_adapter("iemocap", arch, use_kernels=True, remat=remat,
                          dropout=0.0, loss_backend="pallas").cohort_step(
                              *args)
            for remat in (False, True)]
    (n0, g0, t0, d0), (n1, g1, t1, d1) = outs
    torch.testing.assert_close(t1, t0, rtol=0, atol=1e-6)
    for a, b in zip(tree_leaves((n1, g1, d1)), tree_leaves((n0, g0, d0))):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_eq12_aggregation_over_backbone_trees(arch):
    """Eq. 12 over encoder trees equals the manual per-leaf weighted sum,
    zero-weight rows dropping out exactly and a zero-sum modality left
    untouched."""
    K = 3
    gp = params_from_numpy(_jax_params("iemocap", arch, 0), "cpu")
    clients = [params_from_numpy(_jax_params("iemocap", arch, s), "cpu")
               for s in range(1, K + 1)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *clients)
    w = {"audio": np.array([0.5, 0.5, 0.0]),
         "text": np.array([0.0, 0.25, 0.75])}
    out = tagg.aggregate_stacked(gp, stacked, w)
    for m in gp:
        want = tree_map(lambda x: sum(float(w[m][k]) * x[k]
                                      for k in range(K)), stacked[m])
        for a, b in zip(tree_leaves(out[m]), tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    out0 = tagg.aggregate_stacked(gp, stacked,
                                  {"audio": np.zeros(K), "text": w["text"]})
    for a, b in zip(tree_leaves(out0["audio"]), tree_leaves(gp["audio"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,dataset", [("transformer", "crema_d"),
                                          ("ssd", "iemocap")])
def test_experiment_matches_jax_round_by_round(arch, dataset):
    """The whole training path: the port's kernel engine on the CPU against
    the JAX package's plain batched engine, same seed, dropout 0.0 on both
    sides, the JAX package's initial params."""
    kw = dict(K=4, n_samples=160, arch=arch)
    j = JExperiment(dataset, engine="batched:seq", **kw)
    j.adapter = jmake_adapter(dataset, arch, dropout=0.0)
    t = TExperiment(dataset, engine="batched:seq+pallas", device="cpu", **kw)
    t.adapter = tmake_adapter(dataset, arch, dropout=0.0,
                              loss_backend="pallas", use_kernels=True)
    t.global_params = params_from_numpy(_np(j.global_params), "cpu")
    t.init_params = params_from_numpy(_np(j.init_params), "cpu")
    fa_ops.reset_launch_counts()
    ssd_ops.reset_launch_counts()
    for _ in range(2):
        rj, rt = j.run_round(), t.run_round()
        assert rt.participants == rj.participants
        assert rt.failures == rj.failures
        assert rt.energy_total == pytest.approx(rj.energy_total, abs=1e-9)
        assert rt.metrics["loss"] == pytest.approx(rj.metrics["loss"],
                                                   abs=1e-4)
        for a, b in zip(tree_leaves(params_to_numpy(t.global_params)),
                        jax.tree.leaves(_np(j.global_params))):
            np.testing.assert_allclose(a, b, **TOL)
        np.testing.assert_allclose(t.model_dist, j.model_dist, **TOL)
        for m in t.all_mods:
            assert t.bound.zeta[m] == pytest.approx(j.bound.zeta[m],
                                                    rel=1e-4)
            np.testing.assert_allclose(t.bound.delta[m], j.bound.delta[m],
                                       rtol=1e-4)
    assert sum(len(r.participants) for r in t.history) > 0
    # the CPU path runs the plain versions only
    assert fa_ops.launch_counts() == {"flash_attention_fwd": 0}
    assert ssd_ops.launch_counts() == {"ssd_chunk_fwd": 0}
