"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

The cases of ``tests/test_moe.py`` — shape, a huge capacity equal to the
dense gate-weighted expert sum, capacity drops, group-count invariance,
the shared expert — each run on both packages from the same numpy params
and inputs, with the output, the Switch aux loss and the gradients of
``sum(y · cot) + aux`` with respect to the input and every param held
against JAX's.  Then the MoE layer inside the LM: reduced llama4-scout,
kimi-k2 and jamba (hybrid: MoE plus Mamba2) through the bulk prefill and
teacher-forced decode, against the JAX package's (next tokens, logits and
every cache leaf), on both the kernel route (``impl="pallas"``: on the
CPU the kernels' plain versions) and the plain route.

Tolerance: float32 throughout; 1e-5 of the larger of 1 and the
reference's largest magnitude for the layer alone (outputs, aux,
gradients), 1e-4 for the LM's logits and caches, as
``tests/test_torch_lm.py``; tokens identical.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from repro.configs import ARCHS as JARCHS
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JConfig
from repro.models.moe import init_moe as jinit_moe
from repro.models.moe import moe_apply as jmoe_apply
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.trees import tree_leaves
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.moe import init_moe, moe_apply

MOE_ARCHS = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "jamba-v0.1-52b")
TOL_LAYER, TOL_LM = 1e-5, 1e-4


def assert_close(got, want, what, rel=TOL_LAYER):
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max|err| {err:.3e} > {tol:.3e}"


def _cfgs(E=4, k=2, cf=1.25, shared=0):
    kw = dict(name="t", arch_type="moe", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=128, n_experts=E, top_k=k,
              expert_d_ff=48, n_shared_experts=shared, capacity_factor=cf,
              dtype="float32")
    return JConfig(**kw), TConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _both(jcfg, tcfg, seed, x, n_groups=1):
    """Both packages' (y, aux, grads) on JAX's params for ``seed`` and the
    input x; grads of sum(y · cot) + aux, w.r.t. x and every param."""
    jp = jinit_moe(jax.random.key(seed), jcfg)
    cot = np.random.default_rng(seed + 100).normal(size=x.shape).astype(
        np.float32)

    def jloss(p, xx):
        y, aux = jmoe_apply(p, xx, jcfg, n_groups=n_groups)
        return (y * cot).sum() + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = params_from_numpy(_np(jp), "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tx = torch.as_tensor(x).requires_grad_()
    ty, taux = moe_apply(tp, tx, tcfg, n_groups=n_groups)
    grads = torch.autograd.grad((ty * torch.as_tensor(cot)).sum() + taux,
                                leaves + [tx])
    return dict(jp=jp, tp=tp, jy=np.asarray(jy), jaux=float(jaux),
                jgrads=jax.tree.leaves(jgp) + [jgx], ty=ty.detach(),
                taux=taux.detach(), tgrads=grads)


def _assert_match(r, what):
    assert_close(r["ty"], r["jy"], f"{what} output")
    assert_close(r["taux"], r["jaux"], f"{what} aux")
    assert len(r["tgrads"]) == len(r["jgrads"])
    for i, (a, b) in enumerate(zip(r["tgrads"], r["jgrads"])):
        assert_close(a, b, f"{what} grad {i}")


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the layer: tests/test_moe.py's cases, on both packages
# ---------------------------------------------------------------------------
def test_output_shape_finite_and_matches_jax():
    jcfg, tcfg = _cfgs()
    r = _both(jcfg, tcfg, 0, _x(0, (2, 16, 32)))
    assert tuple(r["ty"].shape) == (2, 16, 32)
    assert torch.isfinite(r["ty"]).all() and float(r["taux"]) > 0
    _assert_match(r, "E=4 k=2")


def test_huge_capacity_equals_dense_expert_sum():
    """With capacity >> tokens each token's output is the gate-weighted
    sum of its top-k experts (no drops, no double counting)."""
    jcfg, tcfg = _cfgs(E=4, k=2, cf=50.0)
    x = _x(0, (1, 8, 32))
    r = _both(jcfg, tcfg, 1, x)
    _assert_match(r, "cf=50")
    p = r["tp"]
    xf = torch.as_tensor(x).reshape(-1, 32)
    probs = torch.softmax(xf @ p["router"], -1)
    gates, idx = torch.topk(probs, 2, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)

    def expert(e, v):
        h = torch.nn.functional.silu(v @ p["wg"][e]) * (v @ p["wu"][e])
        return h @ p["wd"][e]

    want = torch.stack([
        sum(gates[t, j] * expert(int(idx[t, j]), xf[t]) for j in range(2))
        for t in range(8)])
    torch.testing.assert_close(r["ty"].reshape(-1, 32), want, rtol=2e-4,
                               atol=2e-5)


def test_capacity_one_drops_overflow():
    """A tiny capacity factor drops most pairs: smaller outputs, still
    finite, and equal to JAX's (the same pairs dropped)."""
    (jlo, tlo), (jhi, thi) = _cfgs(cf=0.05), _cfgs(cf=50.0)
    x = _x(1, (1, 32, 32))
    lo, hi = _both(jlo, tlo, 2, x), _both(jhi, thi, 2, x)
    _assert_match(lo, "cf=0.05")
    assert torch.isfinite(lo["ty"]).all()
    assert float(lo["ty"].abs().sum()) < float(hi["ty"].abs().sum())


@pytest.mark.parametrize("n_groups", [1, 4])
def test_group_count_invariance_without_drops(n_groups):
    jcfg, tcfg = _cfgs(cf=50.0)
    x = _x(2, (2, 16, 32))
    r = _both(jcfg, tcfg, 3, x, n_groups=n_groups)
    _assert_match(r, f"n_groups={n_groups}")
    y1, _ = moe_apply(r["tp"], torch.as_tensor(x), tcfg, n_groups=1)
    torch.testing.assert_close(r["ty"], y1.detach(), rtol=2e-4, atol=2e-5)


def test_groups_with_drops_match_jax():
    """At the default capacity factor, 4 groups route (and drop) each on
    its own, as the JAX package's vmap over groups does."""
    jcfg, tcfg = _cfgs()
    _assert_match(_both(jcfg, tcfg, 4, _x(3, (2, 32, 32)), n_groups=4),
                  "n_groups=4 cf=1.25")


def test_shared_expert_always_active():
    jcfg, tcfg = _cfgs(shared=1)
    r = _both(jcfg, tcfg, 4, _x(4, (1, 4, 32)))
    assert "shared" in r["tp"]
    _assert_match(r, "shared expert")
    p = init_moe(torch.Generator().manual_seed(0), tcfg)
    y, _ = moe_apply(p, torch.zeros((1, 4, 32)), tcfg)
    assert tuple(y.shape) == (1, 4, 32)
    assert [tuple(t.shape) for t in tree_leaves(p)] == \
        [tuple(t.shape) for t in jax.tree.leaves(r["jp"])]


@pytest.mark.parametrize("E,k,seed", [(2, 1, 0), (5, 2, 7), (8, 2, 11)])
def test_aux_loss_lower_bound_and_matches_jax(E, k, seed):
    """Switch aux ≥ 1 at perfect balance (Cauchy-Schwarz), finite, and
    JAX's value."""
    jcfg, tcfg = _cfgs(E=E, k=k)
    r = _both(jcfg, tcfg, seed, _x(seed, (1, 16, 32)))
    assert np.isfinite(float(r["taux"])) and float(r["taux"]) >= 0.99
    _assert_match(r, f"E={E} k={k}")


def test_init_moe_on_the_meta_device_has_jax_shapes():
    jcfg, tcfg = _cfgs(shared=2)
    with torch.device("meta"):
        p = init_moe(None, tcfg)
    jp = jax.eval_shape(lambda k: jinit_moe(k, jcfg), jax.random.key(0))
    assert [(tuple(t.shape), str(t.dtype)) for t in tree_leaves(p)] == \
        [(tuple(t.shape), "torch." + t.dtype.name)
         for t in jax.tree.leaves(jp)]


def test_mixed_cohort_raises():
    """MoE runs on the LM's K=1 views: a K>1 cohort raises."""
    cfg = TARCHS["llama4-scout-17b-a16e"].reduced()
    spec = cfg.block_pattern()[0]
    p = TT.init_layer(torch.Generator().manual_seed(0), cfg, spec)
    p2 = {k: v for k, v in p.items()}
    from repro_torch.core.trees import tree_map
    p2 = tree_map(lambda t: torch.stack([t, t]), p2)
    with pytest.raises(NotImplementedError, match="K=1"):
        TT.apply_layer(p2, torch.zeros((2, 1, 4, cfg.d_model)), cfg, spec)


# ---------------------------------------------------------------------------
# the MoE LM: bulk prefill and teacher-forced decode against JAX's
# ---------------------------------------------------------------------------
B, S = 2, 16


def _lm_cfgs(name):
    over = {"ssm_chunk": 8} if JARCHS[name].ssm_state else {}
    return (dataclasses.replace(JARCHS[name].reduced(), **over),
            dataclasses.replace(TARCHS[name].reduced(), **over))


@pytest.fixture(scope="module")
def moe_lm_refs():
    refs = {}

    def get(name):
        if name in refs:
            return refs[name]
        jcfg, tcfg = _lm_cfgs(name)
        params = jsteps.init_fn(jcfg)(jax.random.key(2))
        tokens = np.random.default_rng(5).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        jt = jnp.asarray(tokens)
        step = jax.jit(lambda p, c, t, i: JT.decode_step(p, c, t, i, jcfg))
        cache = JT.init_cache(jcfg, B, S + 1, jnp.float32)
        dec = []
        for i in range(S):
            lg, cache = step(params, cache, jt[:, i:i + 1], jnp.int32(i))
            dec.append(np.asarray(lg[:, 0]))
        nxt, bulk = jax.jit(jsteps.make_bulk_prefill(jcfg, attn_chunk=8))(
            params, jt, JT.init_cache(jcfg, B, S + 1, jnp.float32))
        refs[name] = dict(tcfg=tcfg, params=_np(params), tokens=tokens,
                          dec=np.stack(dec, 1), tf_cache=_np(cache),
                          next=np.asarray(nxt), bulk=_np(bulk))
        return refs[name]
    return get


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_bulk_prefill_matches_jax(moe_lm_refs, name, impl):
    r = moe_lm_refs(name)
    cfg = r["tcfg"]
    p = params_from_numpy(r["params"], "cpu")
    cache = TT.init_cache(cfg, B, S + 1, torch.float32, "cpu")
    nxt, cache = tsteps.make_bulk_prefill(cfg, attn_chunk=8, impl=impl)(
        p, torch.as_tensor(r["tokens"]).long(), cache)
    np.testing.assert_array_equal(nxt.numpy(), r["next"])
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(r["bulk"])):
        assert_close(a, b, f"{name} bulk cache ({impl})", TOL_LM)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_teacher_forced_decode_matches_jax(moe_lm_refs, name):
    """S decode steps from an empty cache through ``make_serve_step`` (the
    MoE routes each step's B tokens as one group): each step's logits and
    the cache left behind."""
    r = moe_lm_refs(name)
    cfg = r["tcfg"]
    p = params_from_numpy(r["params"], "cpu")
    tokens = torch.as_tensor(r["tokens"]).long()
    cache = TT.init_cache(cfg, B, S + 1, torch.float32, "cpu")
    for i in range(S):
        lg, cache = TT.decode_step(p, cache, tokens[:, i:i + 1],
                                   torch.tensor(i), cfg)
        assert_close(lg[:, 0], r["dec"][:, i], f"{name} decode step {i}",
                     TOL_LM)
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(r["tf_cache"])):
        assert_close(a, b, f"{name} teacher-forced cache", TOL_LM)
    assert params_to_numpy(p).keys() == r["params"].keys()


# ---------------------------------------------------------------------------
# the plain path, bit for bit: the dry run's split dispatch is a DTensor
# branch beside it
# ---------------------------------------------------------------------------
PLAIN_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                             "torch_moe_plain.npz")


def _plain_case():
    """numpy params, input and cotangent of a 4-group MoE layer with a
    shared expert and capacity drops (E=4, k=2, capacity factor 1.25)."""
    rng = np.random.default_rng(22)
    D, E, Fd, Fs = 32, 4, 48, 48

    def normal(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    params = {"router": normal(D, E), "wg": normal(E, D, Fd),
              "wu": normal(E, D, Fd), "wd": normal(E, Fd, D),
              "shared": {"wg": {"w": normal(D, Fs)},
                         "wu": {"w": normal(D, Fs)},
                         "wd": {"w": normal(Fs, D)}}}
    x = rng.normal(size=(2, 32, D)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    return params, x, cot


def _plain_outputs(params, x, cot, tcfg):
    """(y, aux, grads of sum(y · cot) + aux w.r.t. every param, then x) of
    the port's plain path, as numpy."""
    tp = params_from_numpy(params, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tx = torch.as_tensor(x).requires_grad_()
    y, aux = moe_apply(tp, tx, tcfg, n_groups=4)
    grads = torch.autograd.grad((y * torch.as_tensor(cot)).sum() + aux,
                                leaves + [tx])
    return ([y.detach().numpy(), aux.detach().numpy()]
            + [g.numpy() for g in grads])


def test_plain_path_is_the_parents_bit_for_bit_and_matches_jax():
    """``moe_apply`` on plain tensors equals, bit for bit, the outputs the
    plain path gave before the dry run's split dispatch was added (the
    fixture), and matches the JAX package's ``moe_apply`` on the same
    params at the layer tolerance."""
    jcfg, tcfg = _cfgs(shared=1)
    params, x, cot = _plain_case()
    got = _plain_outputs(params, x, cot, tcfg)
    with np.load(PLAIN_FIXTURE) as f:
        want = [f[f"a{i}"] for i in range(len(f.files))]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert np.array_equal(a, b), f"output {i} differs from the fixture"

    def jloss(p, xx):
        y, aux = jmoe_apply(p, xx, jcfg, n_groups=4)
        return (y * cot).sum() + aux, (y, aux)

    jp = jax.tree.map(jnp.asarray, params)
    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    assert_close(got[0], jy, "output")
    assert_close(got[1], jaux, "aux")
    for i, (a, b) in enumerate(zip(got[2:], jax.tree.leaves(jgp) + [jgx])):
        assert_close(a, b, f"grad {i}")
