"""The port's cohort BGD step (``repro_torch.fl.client``) against the JAX
package's ``cohort_step``, and the port's dropout bits.

K=3 clients with N=8 padded samples, dropout 0.0 (the port cannot replay
``jax.random``), per-client modality availability and sample-mask padding;
the JAX kernel loss runs in interpret mode.  Tolerances: totals 1e-5,
params, grads and distances 1e-4 (float32, another reduction order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from repro.fl.client import PaperModelAdapter as JAdapter
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.trees import tree_leaves
from repro_torch.fl.client import PaperModelAdapter as TAdapter
from repro_torch.kernels.fusion_loss import ops as tops
from repro_torch.models import paper_models as tpm

TOL = dict(rtol=1e-4, atol=1e-4)
K, N = 3, 8


C = 6                                               # CREMA-D classes


def _cohort():
    rng = np.random.default_rng(0)
    feats = {"audio": rng.normal(size=(K, N, 32, 11)).astype(np.float32),
             "image": rng.normal(size=(K, N, 32, 32, 3)).astype(np.float32)}
    labels = rng.integers(0, C, (K, N)).astype(np.int32)
    smask = np.ones((K, N), np.float32)
    smask[1, 5:] = 0.0                              # padded client shard
    avail = {"audio": np.array([1, 1, 0], np.float32),  # client 1: audio only
             "image": np.array([1, 0, 0], np.float32)}  # client 2 unscheduled
    seeds = np.array([5, 7, 11], np.uint32)
    return feats, labels, smask, avail, seeds


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_cohort_step_matches_jax(backend):
    dataset = "crema_d"
    feats, labels, smask, avail, seeds = _cohort()
    tad = TAdapter(dataset, dropout=0.0, loss_backend=backend)
    params = params_to_numpy(tad.init_global(torch.Generator().manual_seed(0),
                                             "cpu"))
    init = params_to_numpy(tad.init_global(torch.Generator().manual_seed(1),
                                           "cpu"))
    mods = tuple(sorted(feats))

    jad = JAdapter(dataset, dropout=0.0, loss_backend=backend)
    jnew, jgrads, jtot, jdist = jax.jit(jad.cohort_step(mods))(
        *(jax.tree.map(jnp.asarray, t) for t in (params, init, feats)),
        jnp.asarray(labels), jnp.asarray(smask),
        {m: jnp.asarray(a) for m, a in avail.items()}, jnp.asarray(seeds))

    tnew, tgrads, ttot, tdist = tad.cohort_step(
        params_from_numpy(params, "cpu"), params_from_numpy(init, "cpu"),
        {m: torch.as_tensor(x) for m, x in feats.items()},
        torch.as_tensor(labels), torch.as_tensor(smask),
        {m: torch.as_tensor(a) for m, a in avail.items()},
        torch.as_tensor(seeds.astype(np.int64)))

    np.testing.assert_allclose(ttot.numpy(), jtot, rtol=1e-5, atol=1e-5)
    for m in mods:
        np.testing.assert_allclose(tdist[m].numpy(), jdist[m], **TOL)
        for got, want in ((tnew, jnew), (tgrads, jgrads)):
            for a, b in zip(tree_leaves(got[m]), jax.tree.leaves(want[m])):
                np.testing.assert_allclose(a.numpy(), b, **TOL)
    # the unscheduled client: F = log C, gradient exactly zero
    assert float(ttot[2]) == pytest.approx(np.log(C), rel=1e-6)
    for m in mods:
        assert all(bool((g[2] == 0).all()) for g in tree_leaves(tgrads[m]))
    assert tops.launch_counts() == {k: 0 for k in tops.launch_counts()}


def test_dropout_keeps_one_minus_p():
    keys = torch.arange(4, dtype=torch.int64) * 977 + 3
    for p in (0.1, 0.5):
        keep = tpm.dropout_keep(keys, 64, (32, 50), p)
        assert keep.shape == (4, 64, 32, 50)
        assert float(keep.float().mean()) == pytest.approx(1 - p, abs=0.01)


def test_dropout_masks_depend_only_on_seed_modality_and_sample():
    seeds = torch.tensor([5, 9, 5], dtype=torch.int64)
    keys = tpm.fold_in(seeds, tpm.MODALITY_INDEX["audio"])
    keep = tpm.dropout_keep(keys, 8, (4, 3), 0.3)
    # client 0 and client 2 share a seed: same masks at any cohort position
    assert torch.equal(keep[0], keep[2])
    assert not torch.equal(keep[0], keep[1])
    # a shorter (unpadded) batch draws the same masks for its samples
    assert torch.equal(tpm.dropout_keep(keys, 5, (4, 3), 0.3), keep[:, :5])
    # another modality draws another stream
    text = tpm.fold_in(seeds, tpm.MODALITY_INDEX["text"])
    assert not torch.equal(tpm.dropout_keep(text, 8, (4, 3), 0.3), keep)


def test_dropout_zero_equals_no_dropout_and_p_changes_logits():
    gen = torch.Generator().manual_seed(0)
    p1 = tpm.init_lstm_model(gen, 11, 50, 6)
    stacked = {k: {n: x[None].expand(2, *x.shape) for n, x in v.items()}
               for k, v in p1.items()}
    x = torch.randn(2, 3, 8, 11, generator=gen)
    seeds = tpm.fold_in(torch.tensor([1, 2]), 0)
    base = tpm.lstm_apply(stacked, x)
    assert torch.equal(tpm.lstm_apply(stacked, x, dropout_keys=seeds,
                                      dropout=0.0), base)
    assert not torch.allclose(tpm.lstm_apply(stacked, x, dropout_keys=seeds,
                                             dropout=0.5), base)
