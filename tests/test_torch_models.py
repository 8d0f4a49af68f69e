"""The port's paper models (``repro_torch.models.paper_models``) against the
JAX package's, on parameters carried across by ``repro_torch.convert``.

The port's apply functions take per-client stacks [K, ...]; the JAX
functions run client by client.  Tolerances are float32 ones (forward 1e-5,
gradients 1e-4): the two packages reduce in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import paper_models as jpm
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.trees import tree_leaves, tree_map
from repro_torch.models import paper_models as tpm

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
K = 2


def _client_params(init, seed):
    """K clients' params as numpy (drawn by the port's init, which has the
    JAX package's layout) and their stacked torch twin."""
    ps = [params_to_numpy(init(torch.Generator().manual_seed(seed + k)))
          for k in range(K)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *ps)
    return ps, params_from_numpy(stacked, "cpu")


def _check_model(japply, tapply, ps, tparams, x):
    """Forward logits and grads of Σ logits·c against the JAX function."""
    rng = np.random.default_rng(0)
    cot = rng.normal(size=(K, x.shape[1], ps[0]["out"]["b"].shape[0]))
    cot = cot.astype(np.float32)
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_()
    out = tapply(tparams, torch.as_tensor(x))
    (out * torch.as_tensor(cot)).sum().backward()

    @jax.jit
    def jfn(p, xk, ck):
        def f(p):
            lg = japply(p, xk)
            return (lg * ck).sum(), lg
        return jax.value_and_grad(f, has_aux=True)(p)

    for k in range(K):
        (_, jlg), jg = jfn(jax.tree.map(jnp.asarray, ps[k]),
                           jnp.asarray(x[k]), jnp.asarray(cot[k]))
        np.testing.assert_allclose(out[k].detach().numpy(), jlg, **FWD)
        tg = tree_map(lambda t: t.grad[k].numpy(), tparams)
        for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
            np.testing.assert_allclose(a, b, **GRAD)


def test_lstm_apply_matches_jax():
    ps, tp = _client_params(lambda gen: tpm.init_lstm_model(gen, 11, 50, 6),
                            seed=1)
    x = np.random.default_rng(1).normal(size=(K, 3, 8, 11)).astype(np.float32)
    _check_model(jpm.lstm_apply, tpm.lstm_apply, ps, tp, x)


def test_cnn_apply_matches_jax():
    ps, tp = _client_params(lambda gen: tpm.init_cnn_model(gen, 6), seed=2)
    x = np.random.default_rng(2).normal(size=(K, 2, 32, 32, 3))
    _check_model(jpm.cnn_apply, tpm.cnn_apply, ps, tp, x.astype(np.float32))


@pytest.mark.parametrize("dataset", ["crema_d", "iemocap"])
def test_modal_logits_matches_jax(dataset):
    init = {"crema_d": tpm.init_crema_model,
            "iemocap": tpm.init_iemocap_model}[dataset]
    ps, tp = _client_params(init, seed=3)
    rng = np.random.default_rng(3)
    shapes = {"audio": (8, 11), "image": (32, 32, 3), "text": (6, 100)}
    feats = {m: rng.normal(size=(K, 2) + shapes[m]).astype(np.float32)
             for m in ps[0]}
    out = tpm.modal_logits(tp, {m: torch.as_tensor(x)
                                for m, x in feats.items()})
    for k in range(K):
        jl = jax.jit(jpm.modal_logits)(
            ps[k], {m: jnp.asarray(x[k]) for m, x in feats.items()})
        for m in feats:
            np.testing.assert_allclose(out[m][k].numpy(), jl[m], **FWD)


def test_torch_init_matches_jax_layout_and_scales():
    """The port draws its own init from a torch.Generator: the JAX package's
    leaf names, shapes and dtypes, at the JAX package's scales (uniform
    ±1/√H for the LSTM, normal/√d for dense layers, scaled He for convs)."""
    for jinit, tinit in ((jpm.init_crema_model, tpm.init_crema_model),
                         (jpm.init_iemocap_model, tpm.init_iemocap_model)):
        j = jax.eval_shape(jinit, jax.random.key(0))
        t = params_to_numpy(tinit(torch.Generator().manual_seed(0)))
        assert jax.tree.structure(j) == jax.tree.structure(t)
        for a, b in zip(jax.tree.leaves(j), jax.tree.leaves(t)):
            assert a.shape == b.shape and a.dtype == b.dtype
    t = params_to_numpy(tpm.init_crema_model(torch.Generator().manual_seed(0)))
    H = 50
    np.testing.assert_allclose(t["audio"]["lstm0"]["wh"].std(),
                               1 / np.sqrt(3 * H), rtol=0.05)
    np.testing.assert_allclose(t["audio"]["fc"]["w"].std(), 1 / np.sqrt(H),
                               rtol=0.1)
    np.testing.assert_allclose(t["image"]["c1"].std(),
                               np.sqrt(2 / (25 * 16)) * 0.35, rtol=0.1)
    assert not t["audio"]["lstm0"]["b"].any()


def test_lstm_backward_gradcheck_and_naive_loop_f64():
    """The hand-written backward against numerical gradients and against
    autograd through the naive loop, in float64."""
    rng = np.random.default_rng(4)
    Kc, B, T, d, H = 2, 3, 4, 3, 2
    args = [torch.tensor(rng.normal(size=s) * 0.5, requires_grad=True)
            for s in ((Kc, d, 4 * H), (Kc, H, 4 * H), (Kc, 4 * H),
                      (Kc, B, T, d))]
    assert torch.autograd.gradcheck(tpm.LSTMScan.apply, args)
    cot = torch.as_tensor(rng.normal(size=(Kc, B, T, H)))
    hand = torch.autograd.grad((tpm.LSTMScan.apply(*args) * cot).sum(), args)
    hs, _, _ = tpm._lstm_fwd_loop(*args)
    naive = torch.autograd.grad((hs.permute(1, 2, 0, 3) * cot).sum(), args)
    for a, b in zip(hand, naive):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_same_maxpool_asymmetric_padding_matches_jax():
    """SAME 5x5/3 pool at H=W=32 pads (1, 2) with −inf; ReLU zeros tie, and
    both packages split the gradient of ties the same way."""
    rng = np.random.default_rng(5)
    y = np.maximum(rng.normal(size=(2, 32, 32, 3)), 0).astype(np.float32)
    cot = rng.normal(size=(2, 11, 11, 3)).astype(np.float32)
    jout, jvjp = jax.vjp(jpm._maxpool, jnp.asarray(y))
    (jgrad,) = jvjp(jnp.asarray(cot))
    ty = torch.tensor(y.transpose(0, 3, 1, 2), requires_grad=True)   # NCHW
    tout = tpm._maxpool(ty)
    assert tout.shape == (2, 3, 11, 11)
    (tout * torch.as_tensor(cot.transpose(0, 3, 1, 2))).sum().backward()
    np.testing.assert_array_equal(tout.detach().numpy().transpose(0, 2, 3, 1),
                                  jout)
    np.testing.assert_allclose(ty.grad.numpy().transpose(0, 2, 3, 1), jgrad,
                               rtol=1e-6, atol=1e-6)
