"""The port's LM training path against the JAX package's, on the CPU.

* ``optim/``: every optimizer's ``init``/``update`` and ``apply_updates``
  on identical trees and gradients, with constant and scheduled learning
  rates, the states compared leaf by leaf after each update; the
  schedules, ``global_norm`` and ``clip_by_global_norm``.
* ``data/tokens.py``: ``TokenStream`` and ``vlm_batch`` bit for bit.
* ``launch/steps.make_train_step`` for every arch of the registry, reduced
  (B=2, S=64, as ``tests/test_models_smoke.py``), with the optimizer
  ``make_optimizer`` picks for the FULL config (Adafactor from 30 B
  params on, AdamW below), through the kernel route (``impl="pallas"``:
  on the CPU the kernels' plain versions): three steps, each from the JAX
  package's params and optimizer state of the step before (losses,
  params and every state leaf), and three free-running steps (losses).
* the VLM functions (``models/multimodal.py``), ``vlm_loss_chunked`` on
  both routes against the JAX package's (value and gradients) and against
  ``vlm_modal_logits`` + ``core.fusion.multimodal_loss``.
* the MoE aux in ``transformer.loss_fn`` with and without ``loss_chunk``.
* bfloat16 params with the stub frontends' float32 features, as
  ``train_standard`` feeds them: the Whisper encoder and audio head and
  the VLM's vision head promote to float32 as in the JAX package (held
  within the float32 tolerances); the bfloat16 text logits within 3e-2
  of their largest magnitude (readings ~1e-2: a few bfloat16 ulps, the
  two packages rounding bfloat16 products apart), the losses within 1e-4
  relative (readings <= 7e-6).
* ``models/analysis.py``, and ``python -m repro_torch.launch.train`` in a
  subprocess.

Tolerances (float32): a loss within 1e-5 of max(1, |loss|); state leaves
and gradients within 1e-4 of max(1, the reference's largest magnitude);
params after a step within 1e-4 of that for SGD-like steps.  Adam and
Adafactor normalise each coordinate, so where a gradient is near 0 (its
float32 rounding differs between the packages) the step's sign can flip:
their params are held within ``2.5·lr`` (a flipped coordinate moves 2·lr
at most) and at least 99.9 % of the elements within the 1e-4 bound.  The
free-running losses after three steps are held within 1e-3 relative: a
coordinate flipped at step 0 can flip a router's top-k choice later.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from repro import optim as jopt
from repro.configs import ARCHS as JARCHS
from repro.data import tokens as jtokens
from repro.launch import steps as jsteps
from repro.core import fusion as jfusion
from repro.models import analysis as janalysis
from repro.models import encdec as jed
from repro.models import multimodal as jmm
from repro.models import transformer as JT
from repro_torch import optim as topt
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.core import fusion as tfusion
from repro_torch.core.trees import tree_leaves
from repro_torch.data import tokens as ttokens
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import analysis as tanalysis
from repro_torch.models import encdec as ted
from repro_torch.models import multimodal as tmm
from repro_torch.models import transformer as TT

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
LR = 1e-3
TOL_LOSS, TOL_TREE = 1e-5, 1e-4


def _f32(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def assert_close(got, want, what, rel=TOL_TREE):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, f"{what}: max|err| {err:.3e} > {tol:.3e}"


def assert_trees_close(got, want, what, rel=TOL_TREE):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        assert_close(a, b, f"{what} leaf {i}", rel)


def assert_params_close(got, want, what, normalised: bool):
    """Params after a step: within 1e-4 (relative), or for a normalising
    optimizer within 2.5·lr with at least 99.9 % of the elements inside
    the 1e-4 bound (``normalised``)."""
    if not normalised:
        return assert_trees_close(got, want, what)
    n_out = n = 0
    for i, (a, b) in enumerate(zip(tree_leaves(got), jax.tree.leaves(want))):
        a, b = _f32(a), _f32(b)
        err = np.abs(a - b)
        assert float(err.max()) <= 2.5 * LR, \
            f"{what} leaf {i}: max|err| {float(err.max()):.3e} > 2.5·lr"
        n_out += int((err > TOL_TREE * max(1.0, float(np.abs(b).max())))
                     .sum())
        n += err.size
    assert n_out <= 1e-3 * n, f"{what}: {n_out} of {n} elements flipped"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# optim/
# ---------------------------------------------------------------------------
def _tree(rng):
    return {"a": rng.normal(size=(6, 5)).astype(np.float32),
            "b": {"w": rng.normal(size=(2, 4, 3)).astype(np.float32),
                  "bias": rng.normal(size=(7,)).astype(np.float32)},
            "s": np.asarray(rng.normal(), np.float32).reshape(())}


OPT_CASES = [("sgd", {}), ("momentum", {"beta": 0.8}), ("adam", {}),
             ("adamw", {"weight_decay": 0.1}), ("adafactor", {})]


@pytest.mark.parametrize("sched", ["const", "warmup_cosine", "cosine"])
@pytest.mark.parametrize("name,kw", OPT_CASES, ids=[c[0] for c in OPT_CASES])
def test_optimizer_updates_and_states_match_jax(name, kw, sched):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    lrs = {"const": (LR, LR),
           "warmup_cosine": (jopt.warmup_cosine(LR, 2, 5),
                             topt.warmup_cosine(LR, 2, 5)),
           "cosine": (jopt.cosine_schedule(LR, 4), topt.cosine_schedule(
               LR, 4))}[sched]
    jo = jopt.OPTIMIZERS[name](lrs[0], **kw)
    to = topt.OPTIMIZERS[name](lrs[1], **kw)
    jp, tp = params, params_from_numpy(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    assert_trees_close(ts, js, f"{name} init")
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for i in range(3):
        grads = _tree(rng)
        ju, js = jo.update(grads, js, jp)
        tu, ts = to.update(params_from_numpy(grads, "cpu"), ts, tp)
        assert_trees_close(tu, ju, f"{name}/{sched} update {i}", 1e-5)
        assert_trees_close(ts, js, f"{name}/{sched} state {i}", 1e-5)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        assert_trees_close(tp, jp, f"{name}/{sched} params {i}", 1e-5)
        assert all(a.dtype == torch.float32 for a in tree_leaves(tp))


def test_apply_updates_keeps_bfloat16_and_adafactor_layout():
    """A bfloat16 param takes its float32 update in its own dtype; the
    Adafactor state has the JAX package's ``{"r", "c"} | {"v"}`` leaves."""
    p = {"w": torch.ones((3, 4), dtype=torch.bfloat16),
         "v": torch.ones((4,), dtype=torch.bfloat16)}
    o = topt.adafactor(LR)
    st = o.init(p)
    assert sorted(st["f"]["w"]) == ["c", "r"] and sorted(st["f"]["v"]) == \
        ["v"]
    assert tuple(st["f"]["w"]["r"].shape) == (3,)
    assert tuple(st["f"]["w"]["c"].shape) == (4,)
    u, st = o.update({k: torch.full_like(x, 0.5) for k, x in p.items()},
                     st, p)
    new = topt.apply_updates(p, u)
    assert all(x.dtype == torch.bfloat16 for x in new.values())
    assert int(st["step"]) == 1


def test_schedules_norms_and_clipping_match_jax():
    for jl, tl in ((jopt.warmup_cosine(3e-4, 10, 50),
                    topt.warmup_cosine(3e-4, 10, 50)),
                   (jopt.cosine_schedule(1e-3, 20, 0.2),
                    topt.cosine_schedule(1e-3, 20, 0.2))):
        for s in range(0, 60, 3):
            assert_close(tl(torch.tensor(s, dtype=torch.int32)),
                         jl(jnp.int32(s)), f"lr at step {s}", 1e-6)
    g = _tree(np.random.default_rng(3))
    tg = params_from_numpy(g, "cpu")
    assert_close(topt.global_norm(tg), jopt.global_norm(g), "norm", 1e-6)
    for max_norm in (0.5, 100.0):
        jc, jn = jopt.clip_by_global_norm(g, max_norm)
        tc, tn = topt.clip_by_global_norm(tg, max_norm)
        assert_trees_close(tc, jc, f"clip {max_norm}", 1e-6)
        assert_close(tn, jn, "clip norm", 1e-6)


# ---------------------------------------------------------------------------
# data/tokens.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq", [(512, 64), (64000, 256), (100, 32)])
def test_token_stream_and_vlm_batch_bit_for_bit(vocab, seq):
    js, ts = jtokens.TokenStream(vocab, seed=7), ttokens.TokenStream(
        vocab, seed=7)
    for _ in range(3):
        a, b = js.batch(4, seq), ts.batch(4, seq)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ja, ta = (m.vlm_batch(np.random.default_rng(2), 2, seq, 16, 8, vocab)
              for m in (jtokens, ttokens))
    for k in ja:
        assert ja[k].dtype == ta[k].dtype
        np.testing.assert_array_equal(ja[k], ta[k])


# ---------------------------------------------------------------------------
# make_train_step, every arch of the registry
# ---------------------------------------------------------------------------
def _batch(cfg, rng, B=2, S=64):
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.arch_type == "vlm":
        b["patches"] = rng.normal(size=(B, 8, cfg.frontend_dims[0])).astype(
            np.float32)
    if cfg.arch_type == "audio":
        b["src_embeds"] = rng.normal(size=(B, 32, cfg.d_model)).astype(
            np.float32)
    return b


def _tbatch(b):
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32
            else torch.as_tensor(v) for k, v in b.items()}


def _full_count(name):
    return tsteps.param_count(tsteps.params_shape(TARCHS[name]))


@pytest.fixture(scope="module")
def train_refs():
    """Per arch, on first use: the JAX package's three steps (one jit) —
    its params and optimizer state before each step, its losses — and
    the batches."""
    refs = {}

    def get(name):
        if name in refs:
            return refs[name]
        jcfg = JARCHS[name].reduced()
        n_full = jsteps.param_count(jsteps.params_shape(JARCHS[name]))
        jo, opt_name = jsteps.make_optimizer(jcfg, n_full, lr=LR)
        params = jsteps.init_fn(jcfg)(jax.random.key(0))
        if jcfg.arch_type == "vlm":     # a vision head that is not zeros
            params["vision"]["w2"] = 0.02 * jax.random.normal(
                jax.random.key(9), params["vision"]["w2"].shape)
        state = jo.init(params)
        step = jax.jit(jsteps.make_train_step(jcfg, jo, n_groups=1,
                                              attn_chunk=32))
        batches = [_batch(jcfg, np.random.default_rng(i)) for i in range(3)]
        before, losses = [], []
        for b in batches:
            before.append((_np(params), _np(state)))
            params, state, loss = step(params, state,
                                       {k: jnp.asarray(v)
                                        for k, v in b.items()})
            losses.append(float(loss))
        refs[name] = dict(opt=opt_name, batches=batches, before=before,
                          after=(_np(params), _np(state)), losses=losses)
        return refs[name]
    return get


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_train_step_matches_jax_step_by_step(train_refs, name):
    """Three steps through the kernel route, each from the JAX package's
    params and state of the step before: the loss, the params and every
    optimizer state leaf after it."""
    r = train_refs(name)
    cfg = TARCHS[name].reduced()
    to, opt_name = tsteps.make_optimizer(cfg, _full_count(name), lr=LR)
    assert opt_name == r["opt"]
    step = tsteps.make_train_step(cfg, to, n_groups=1, attn_chunk=32)
    nexts = r["before"][1:] + [r["after"]]
    for i, (b, (jp, js), (jp2, js2)) in enumerate(zip(
            r["batches"], r["before"], nexts)):
        tp, ts = params_from_numpy(jp, "cpu"), params_from_numpy(js, "cpu")
        tp, ts, loss = step(tp, ts, _tbatch(b))
        assert_close(loss, r["losses"][i], f"{name} loss {i}", TOL_LOSS)
        assert_trees_close(ts, js2, f"{name} {opt_name} state {i}")
        assert_params_close(tp, jp2, f"{name} params {i}", normalised=True)


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_train_step_free_running_losses_match_jax(train_refs, name):
    """Three steps of the port on its own from JAX's initial params and
    the port's own ``init`` state (held equal to JAX's first)."""
    r = train_refs(name)
    cfg = TARCHS[name].reduced()
    to, _ = tsteps.make_optimizer(cfg, _full_count(name), lr=LR)
    tp = params_from_numpy(r["before"][0][0], "cpu")
    ts = to.init(tp)
    assert_trees_close(ts, r["before"][0][1], f"{name} init state")
    step = tsteps.make_train_step(cfg, to, n_groups=1, attn_chunk=32)
    for i, b in enumerate(r["batches"]):
        tp, ts, loss = step(tp, ts, _tbatch(b))
        assert_close(loss, r["losses"][i], f"{name} loss {i}", 1e-3)


@pytest.mark.parametrize("name", sorted(TARCHS))
def test_every_config_trains_prefills_and_serves_on_the_cpu(name):
    """``init_fn``, ``make_train_step``, ``make_prefill_step``,
    ``make_bulk_prefill`` and ``make_serve_step`` for every config,
    reduced, on the CPU: finite outputs of the right shapes."""
    from repro_torch.models import encdec
    cfg = TARCHS[name].reduced()
    p = tsteps.init_fn(cfg)(torch.Generator().manual_seed(0))
    b = _tbatch(_batch(cfg, np.random.default_rng(0), S=32))
    opt, _ = tsteps.make_optimizer(cfg, lr=LR)
    p2, _, loss = tsteps.make_train_step(cfg, opt, attn_chunk=16)(
        p, opt.init(p), b)
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(x.float()).all() for x in tree_leaves(p2))
    logits = tsteps.make_prefill_step(cfg, attn_chunk=16)(p, b)
    assert tuple(logits.shape) == (2, cfg.vocab_size)
    if cfg.arch_type == "audio":
        enc = encdec.encode(p, b["src_embeds"], cfg)
        cache = encdec.init_dec_cache(cfg, 2, 40, enc.shape[1],
                                      torch.float32, "cpu")
        ck, cv = encdec.cross_kv(p, enc, cfg)
        cache["cross_k"].copy_(ck)
        cache["cross_v"].copy_(cv)
        nxt, cache = tsteps.make_bulk_prefill(cfg, attn_chunk=16)(
            p, b["tokens"], enc, cache)
    else:
        cache = TT.init_cache(cfg, 2, 40, torch.float32, "cpu")
        nxt, cache = tsteps.make_bulk_prefill(cfg, attn_chunk=16)(
            p, b["tokens"], cache)
    tok, _ = tsteps.make_serve_step(cfg)(p, cache, nxt, 32)
    assert tuple(nxt.shape) == tuple(tok.shape) == (2, 1)
    assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# the VLM functions
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def vlm_case():
    jcfg = JARCHS["llava-next-34b"].reduced()
    params = jsteps.init_fn(jcfg)(jax.random.key(4))
    params["vision"]["w2"] = 0.02 * jax.random.normal(
        jax.random.key(5), params["vision"]["w2"].shape)
    b = _batch(jcfg, np.random.default_rng(6), S=32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    modal, aux = jmm.vlm_modal_logits(params, jb, jcfg, attn_chunk=16)
    fused, _, _ = jmm.vlm_fused_forward(params, jb, jcfg, attn_chunk=16)
    chunked = {}
    for chunk in (8, 32):
        def f(p, chunk=chunk):
            return jmm.vlm_loss_chunked(p, jb, jcfg, chunk, attn_chunk=16)[0]
        val, g = jax.jit(jax.value_and_grad(f))(params)
        chunked[chunk] = (float(val), _np(g))
    return dict(cfg=TARCHS["llava-next-34b"].reduced(), params=_np(params),
                batch=b, modal=_np(modal), aux=float(aux),
                fused=np.asarray(fused), chunked=chunked)


def test_vlm_modal_logits_and_fused_forward_match_jax(vlm_case):
    c = vlm_case
    p = params_from_numpy(c["params"], "cpu")
    tb = _tbatch(c["batch"])
    for impl in ("pallas", "xla"):
        modal, aux = tmm.vlm_modal_logits(p, tb, c["cfg"], attn_chunk=16,
                                          impl=impl)
        assert sorted(modal) == ["text", "vision"]
        for m in modal:
            assert_close(modal[m], c["modal"][m], f"vlm {m} ({impl})")
        assert float(aux) == c["aux"] == 0.0
        fused, _, _ = tmm.vlm_fused_forward(p, tb, c["cfg"], attn_chunk=16,
                                            impl=impl)
        assert_close(fused, c["fused"], f"vlm fused ({impl})")
    last = tsteps.make_prefill_step(c["cfg"], attn_chunk=16)(p, tb)
    assert_close(last, c["fused"][:, -1], "vlm prefill step")


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("chunk", [8, 32])
def test_vlm_loss_chunked_matches_jax_value_and_grads(vlm_case, chunk, impl):
    """On the kernel route each chunk's text logits and the compact
    vision head go through ``fused_multimodal_loss`` (its forward and
    backward); the value is JAX's F + G_text + G_vision and the gradients
    JAX's, leaf by leaf."""
    c = vlm_case
    p = params_from_numpy(c["params"], "cpu")
    tb = _tbatch(c["batch"])
    loss = tsteps.make_loss_fn(c["cfg"], attn_chunk=16, loss_chunk=chunk,
                               aux_weight=0.0, impl=impl)
    val, grads = tsteps.value_and_grad(loss, p, tb)
    want, jgrads = c["chunked"][chunk]
    assert_close(val, want, f"vlm chunked loss c={chunk} ({impl})", TOL_LOSS)
    assert_trees_close(grads, jgrads, f"vlm chunked grads c={chunk} ({impl})")
    # against the unchunked modal logits through core.fusion
    modal, _ = tmm.vlm_modal_logits(p, tb, c["cfg"], attn_chunk=16)
    total, _ = tfusion.multimodal_loss(modal, tb["labels"])
    assert_close(val, total, "chunked vs modal logits + multimodal_loss",
                 TOL_LOSS)


def test_vlm_and_audio_losses_route_to_the_fusion_kernels(monkeypatch):
    """The kernel route calls ``fused_multimodal_loss`` (the kernels on a
    card) for the audio and VLM losses; the plain route never does."""
    calls = []
    real = tsteps.fused_multimodal_loss

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tsteps, "fused_multimodal_loss", spy)
    monkeypatch.setattr(tmm, "fused_multimodal_loss", spy)
    for name in ("whisper-base", "llava-next-34b"):
        cfg = TARCHS[name].reduced()
        p = tsteps.init_fn(cfg)(torch.Generator().manual_seed(0))
        b = _tbatch(_batch(cfg, np.random.default_rng(0), S=16))
        for impl, chunk, want in (("xla", None, 0), ("pallas", None, 1),
                                  ("pallas", 8, 2)):
            if chunk and cfg.arch_type != "vlm":
                continue
            calls.clear()
            tsteps.make_loss_fn(cfg, attn_chunk=16, impl=impl,
                                loss_chunk=chunk)(p, b)
            assert len(calls) == want, (name, impl, chunk)


def _bf16_case(name):
    """A reduced arch with bfloat16 params (the head's ``w2`` not zeros)
    and a batch with float32 features, in both packages."""
    jcfg = dataclasses.replace(JARCHS[name].reduced(), dtype="bfloat16")
    tcfg = dataclasses.replace(TARCHS[name].reduced(), dtype="bfloat16")
    params = jsteps.init_fn(jcfg)(jax.random.key(0))
    head = "vision" if jcfg.arch_type == "vlm" else "audio_head"
    params[head]["w2"] = (0.02 * jax.random.normal(
        jax.random.key(9), params[head]["w2"].shape)).astype(jnp.bfloat16)
    b = _batch(jcfg, np.random.default_rng(0))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tp = params_from_numpy(_np(params), "cpu")
    tb = ttrain.to_device(b, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    return jcfg, tcfg, params, jb, tp, tb


TOL_BF16_LOGITS, TOL_BF16_LOSS = 3e-2, 1e-4


def test_whisper_bfloat16_encoder_and_audio_head_promote_as_in_jax():
    """float32 frames under bfloat16 params: the JAX package's ``encode``
    and audio head run in float32, and so do the port's.  The JAX
    package's decoder scan refuses that float32 output (its carry keeps
    the embedding's type); the port's decoder takes it in the stream's
    type, which is JAX's ``decode_fwd`` on the encoder output cast to
    bfloat16."""
    jcfg, tcfg, p, jb, tp, tb = _bf16_case("whisper-base")
    assert tb["src_embeds"].dtype == torch.float32
    je = jed.encode(p, jb["src_embeds"], jcfg, attn_chunk=32)
    te = ted.encode(tp, tb["src_embeds"], tcfg, attn_chunk=32)
    assert je.dtype == jnp.float32 and te.dtype == torch.float32
    assert_close(te, je, "bf16 whisper encoder output", TOL_LOSS)
    ja = jed.audio_head_logits(p, je)
    ta = ted.audio_head_logits(tp, te)
    assert ta.dtype == torch.float32
    assert_close(ta, ja, "bf16 whisper audio head", TOL_LOSS)
    with pytest.raises(TypeError):
        jed.decode_fwd(p, jb["tokens"], je, jcfg, attn_chunk=32)
    jd = jed.decode_fwd(p, jb["tokens"], je.astype(jnp.bfloat16), jcfg,
                        attn_chunk=32)
    td = ted.decode_fwd(tp, tb["tokens"], te, tcfg, attn_chunk=32)
    assert td.dtype == torch.bfloat16
    assert_close(td, jd, "bf16 whisper text logits", TOL_BF16_LOGITS)
    want, _ = jfusion.multimodal_loss({"text": jd, "audio": ja[:, None]},
                                      jb["labels"])
    for impl in ("pallas", "xla"):
        got = tsteps.make_loss_fn(tcfg, attn_chunk=32, impl=impl)(tp, tb)
        assert_close(got, want, f"bf16 whisper loss ({impl})",
                     TOL_BF16_LOSS)


def test_vlm_bfloat16_vision_head_promotes_as_in_jax():
    """float32 patches under bfloat16 params: the vision head is float32
    in both packages, the text logits bfloat16; the loss (both routes,
    with and without ``loss_chunk``) is JAX's."""
    jcfg, tcfg, p, jb, tp, tb = _bf16_case("llava-next-34b")
    assert tb["patches"].dtype == torch.float32
    jm, _ = jmm.vlm_modal_logits(p, jb, jcfg, attn_chunk=32)
    tm, _ = tmm.vlm_modal_logits(tp, tb, tcfg, attn_chunk=32)
    assert jm["vision"].dtype == jnp.float32
    assert tm["vision"].dtype == torch.float32
    assert tm["text"].dtype == torch.bfloat16
    assert_close(tm["vision"], jm["vision"], "bf16 vlm vision head",
                 TOL_LOSS)
    assert_close(tm["text"], jm["text"], "bf16 vlm text logits",
                 TOL_BF16_LOGITS)
    for chunk in (None, 16):
        want = float(jsteps.make_loss_fn(jcfg, attn_chunk=32,
                                         loss_chunk=chunk)(p, jb))
        for impl in ("pallas", "xla"):
            got = tsteps.make_loss_fn(tcfg, attn_chunk=32, impl=impl,
                                      loss_chunk=chunk)(tp, tb)
            assert_close(got, want, f"bf16 vlm loss c={chunk} ({impl})",
                         TOL_BF16_LOSS)


# ---------------------------------------------------------------------------
# the MoE aux in loss_fn (with and without loss_chunk)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
def test_loss_fn_carries_the_moe_aux_with_and_without_loss_chunk(name):
    """``loss_fn`` adds ``aux_weight · aux`` on both of its paths, as the
    JAX package's does (the chunked path once dropped it)."""
    jcfg, tcfg = JARCHS[name].reduced(), TARCHS[name].reduced()
    params = jsteps.init_fn(jcfg)(jax.random.key(3))
    b = _batch(jcfg, np.random.default_rng(3), S=32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    ws = (0.0, 0.01, 1.0)

    @jax.jit
    def jax_losses(params, jb):
        return [JT.loss_fn(params, jb, jcfg, attn_chunk=16, aux_weight=w,
                           loss_chunk=c) for c in (None, 16) for w in ws]

    want = iter(jax_losses(params, jb))
    p, tb = params_from_numpy(_np(params), "cpu"), _tbatch(b)
    _, aux = TT.forward(p, tb["tokens"], tcfg, attn_chunk=16)
    assert float(aux) > 0.5
    for chunk in (None, 16):
        for w in ws:
            got = TT.loss_fn(p, tb, tcfg, attn_chunk=16, aux_weight=w,
                             loss_chunk=chunk)
            assert_close(got, next(want), f"{name} loss_chunk={chunk} w={w}",
                         TOL_LOSS)
    with_chunk = TT.loss_fn(p, tb, tcfg, attn_chunk=16, loss_chunk=16,
                            aux_weight=1.0)
    without = TT.loss_fn(p, tb, tcfg, attn_chunk=16, aux_weight=1.0)
    assert_close(with_chunk, without, "chunked vs unchunked", TOL_LOSS)
    bare = TT.loss_fn(p, tb, tcfg, attn_chunk=16, loss_chunk=16,
                      aux_weight=0.0)
    assert_close(with_chunk - bare, aux, "the aux term", TOL_LOSS)


# ---------------------------------------------------------------------------
# models/analysis.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(JARCHS))
def test_param_counts_and_model_flops(name):
    """Totals equal the JAX package's; N_active equals its too except
    for MoE configs, where the JAX rule (three axes) misses the stacked
    [n_blocks, E, ., .] expert leaves and counts every expert active —
    the port counts top_k / n_experts of them."""
    cfg = TARCHS[name]
    shapes = tsteps.params_shape(cfg)
    total, active = tanalysis.param_counts(shapes, cfg)
    jtotal, jactive = janalysis.param_counts(
        jsteps.params_shape(JARCHS[name]), JARCHS[name])
    assert total == jtotal
    if cfg.n_experts:
        assert jactive == jtotal            # the JAX rule's miss
        experts = sum(x.numel() for path, x in
                      tanalysis._leaves_with_paths(shapes)
                      if tanalysis._EXPERT_RE.search(path))
        assert active == total - experts + experts * cfg.top_k \
            // cfg.n_experts
        assert active < total
    else:
        assert active == jactive == total
    shape = tanalysis.StepShape(seq_len=256, global_batch=8, kind="train")
    f = tanalysis.model_flops(cfg, shapes, shape)
    assert f["model_flops"] == 6 * active * 8 * 256
    assert tanalysis.model_flops(cfg, shapes, shape._replace(
        kind="decode"))["tokens"] == 8


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------
def test_train_cli_runs_reduced_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "3"], env=env, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("[train] arch=qwen3-0.6b reduced=True")
    assert sum(ln.startswith("[train] step ") for ln in lines) == 3
    assert lines[-1].startswith("[train] first->last loss: ")
    assert "jax" not in res.stderr


def test_train_standard_matches_jax_batches_and_first_loss():
    """``train_standard``'s batches (``make_batch``): the same draws as
    the JAX package's ``train_standard``, and from the same params the
    JAX package's first loss on them."""
    for name in ("whisper-base", "llava-next-34b"):
        jcfg = JARCHS[name].reduced()
        tcfg = TARCHS[name].reduced()
        stream = ttokens.TokenStream(tcfg.vocab_size, seed=0)
        b = ttrain.make_batch(tcfg, stream, np.random.default_rng(0), 2, 64)
        want = (jtokens.vlm_batch(np.random.default_rng(0), 2, 64, 16,
                                  jcfg.frontend_dims[0], jcfg.vocab_size)
                if jcfg.arch_type == "vlm"
                else jtokens.TokenStream(jcfg.vocab_size, seed=0).batch(2, 64))
        for k in want:
            np.testing.assert_array_equal(b[k], want[k])
        tb = ttrain.to_device(b, "cpu")
        assert tb["tokens"].dtype == torch.long
        feat = "patches" if jcfg.arch_type == "vlm" else "src_embeds"
        assert tb[feat].dtype == torch.float32
        params = jsteps.init_fn(jcfg)(jax.random.key(0))
        jl = jsteps.make_loss_fn(jcfg, attn_chunk=64)(
            params, {k: jnp.asarray(v) for k, v in b.items()})
        tl = tsteps.make_loss_fn(tcfg, attn_chunk=64)(
            params_from_numpy(_np(params), "cpu"), tb)
        assert_close(tl, jl, f"{name} first loss", TOL_LOSS)


def test_federated_mode_runs_on_the_cpu(capsys):
    exp = ttrain.main(["--mode", "federated", "--device", "cpu", "--rounds",
                       "1", "--n-samples", "80", "--scheduler", "random"])
    assert len(exp.history) == 1
    assert "[federated] final:" in capsys.readouterr().out
