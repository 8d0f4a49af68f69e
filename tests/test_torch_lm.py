"""The port's LM serving stack against the JAX package's, on the CPU.

The configs registry (every config and its ``reduced()``), the LM's
``forward``, its teacher-forced ``decode_step`` and its bulk
``prefill_with_cache`` (next tokens and every cache leaf) for qwen3-0.6b
(qk_norm), qwen2-72b (qkv bias), gemma3-12b (local/global layers; the ring
buffer at ``sliding_window=8``, S=32) and mamba2-370m (``ssm_chunk=8``: the
conv tails and the final SSD state), and the Whisper backbone (``encode``,
``cross_kv``, bulk prefill, decode) — reduced configs in float32, the JAX
package's params carried across by ``params_from_numpy``, inputs drawn
with numpy.  The port runs both its kernel route (``impl="pallas"``: on
the CPU the kernels' plain versions) and its plain route (``"xla"``).

Tolerance: 1e-4 of the larger of 1 and the reference's largest magnitude,
and tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from repro.configs import ARCHS as JARCHS
from repro.launch import steps as jsteps
from repro.models import encdec as jencdec
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 tensor_from_numpy, tensor_to_numpy)
from repro_torch.core.trees import tree_leaves
from repro_torch.launch import steps as tsteps
from repro_torch.launch.serve import teacher_forced_prefill
from repro_torch.models import encdec as tencdec
from repro_torch.models import transformer as TT

LM_ARCHS = ("qwen3-0.6b", "qwen2-72b", "gemma3-12b", "mamba2-370m")
QUEUED_ARCHS = ("kimi-k2-1t-a32b", "llama4-scout-17b-a16e", "jamba-v0.1-52b",
                "llava-next-34b")
IMPLS = ("pallas", "xla")
B, S = 2, 32


def assert_close(got, want, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max|err| {err:.3e} > {tol:.3e}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(name):
    """(JAX config, port config) of the test's reduced variant."""
    over = {}
    if name == "gemma3-12b":
        over["sliding_window"] = 8          # the ring buffer wraps at S=32
    if JARCHS[name].ssm_state:
        over["ssm_chunk"] = 8
    return (dataclasses.replace(JARCHS[name].reduced(), **over),
            dataclasses.replace(TARCHS[name].reduced(), **over))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(JARCHS))
def test_registry_config_and_reduced_equal_jax(name):
    j, t = JARCHS[name], get_config(name)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    for cj, ct in ((j, t), (j.reduced(), t.reduced()),
                   (j.reduced(ssm_chunk=8), t.reduced(ssm_chunk=8))):
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert [dataclasses.asdict(s) for s in ct.block_pattern()] == \
            [dataclasses.asdict(s) for s in cj.block_pattern()]
        assert (ct.hd if ct.n_heads else 0) == (cj.hd if cj.n_heads else 0)
        assert ct.n_blocks == cj.n_blocks


@pytest.mark.parametrize("name", sorted(QUEUED_ARCHS))
def test_moe_and_vlm_archs_raise_naming_roadmap_item_10(name):
    """The MoE and VLM archs raised here until their modules were ported
    (``models/moe.py``, the VLM functions of ``models/multimodal.py``);
    now ``init_fn`` builds them, reduced and at full width (meta tensors),
    with the JAX package's leaf paths, shapes and dtypes."""
    for cfg, jcfg in ((get_config(name).reduced(), JARCHS[name].reduced()),
                      (get_config(name), JARCHS[name])):
        if cfg.n_layers > 2 * len(cfg.block_pattern()):
            shapes = tsteps.params_shape(cfg)
        else:
            shapes = tsteps.init_fn(cfg)(torch.Generator().manual_seed(0))
        jshapes = jsteps.params_shape(jcfg)
        assert tsteps.param_count(shapes) == jsteps.param_count(jshapes)
        assert [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
                for x in tree_leaves(shapes)] == \
            [(tuple(x.shape), x.dtype.name) for x in jax.tree.leaves(jshapes)]


@pytest.mark.parametrize("name", LM_ARCHS + ("qwen3-4b", "whisper-base"))
def test_full_width_param_count_and_layout_equal_jax(name):
    """Meta-tensor shapes at full width: the same leaf paths, shapes and
    dtypes as the JAX package's ``eval_shape``, and the same count."""
    cfg = get_config(name)
    shapes = tsteps.params_shape(cfg)
    jshapes = jsteps.params_shape(JARCHS[name])
    assert tsteps.param_count(shapes) == jsteps.param_count(jshapes)
    assert [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in tree_leaves(shapes)] == \
        [(tuple(x.shape), x.dtype.name) for x in jax.tree.leaves(jshapes)]
    assert all(x.device.type == "meta" for x in tree_leaves(shapes))


def test_bfloat16_leaves_cross_both_ways(tmp_path):
    """A bfloat16 leaf of the JAX package (``ml_dtypes``, or the two-byte
    void an npz gives back) becomes a bfloat16 tensor with the same bits,
    and goes back to numpy as the same bytes."""
    rng = np.random.default_rng(0)
    a = np.asarray(jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16))
    assert a.dtype == ml_dtypes.bfloat16
    np.savez(tmp_path / "b.npz", a=a)
    void = np.load(tmp_path / "b.npz")["a"]
    assert void.dtype == np.dtype("V2")
    for src in (a, void):
        t = tensor_from_numpy(src)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))
        back = tensor_to_numpy(t)
        assert back.dtype == np.dtype("V2")
        np.testing.assert_array_equal(back.view(ml_dtypes.bfloat16), a)
    tree = params_to_numpy(params_from_numpy({"w": a, "n": {"b": void}},
                                             "cpu"))
    assert tree["n"]["b"].tobytes() == a.tobytes()


# ---------------------------------------------------------------------------
# the LM: forward, teacher-forced decode, bulk prefill
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm_refs():
    """Per arch, built on first use: the JAX package's params and its
    forward logits, teacher-forced decode logits and cache, and bulk
    prefill tokens and cache (one jit per function)."""
    refs = {}

    def get(name):
        if name in refs:
            return refs[name]
        jcfg, tcfg = _cfgs(name)
        rng = np.random.default_rng(3)
        params = jsteps.init_fn(jcfg)(jax.random.key(1))
        tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        jt = jnp.asarray(tokens)
        logits, _ = jax.jit(lambda p, t: JT.forward(
            p, t, jcfg, attn_chunk=8))(params, jt)
        step = jax.jit(lambda p, c, t, i: JT.decode_step(p, c, t, i, jcfg))
        cache = JT.init_cache(jcfg, B, S, jnp.float32)
        dec = []
        for i in range(S):
            lg, cache = step(params, cache, jt[:, i:i + 1], jnp.int32(i))
            dec.append(np.asarray(lg[:, 0]))
        nxt, bulk_cache = jax.jit(jsteps.make_bulk_prefill(
            jcfg, attn_chunk=8))(params, jt,
                                 JT.init_cache(jcfg, B, S, jnp.float32))
        refs[name] = dict(tcfg=tcfg, params=_np(params), tokens=tokens,
                          logits=np.asarray(logits), dec=np.stack(dec, 1),
                          tf_cache=_np(cache), next=np.asarray(nxt),
                          bulk_cache=_np(bulk_cache))
        return refs[name]
    return get


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", LM_ARCHS)
def test_forward_logits_match_jax(lm_refs, name, impl):
    r = lm_refs(name)
    p = params_from_numpy(r["params"], "cpu")
    logits, aux = TT.forward(p, torch.as_tensor(r["tokens"]).long(),
                             r["tcfg"], attn_chunk=8, impl=impl)
    assert_close(logits, r["logits"], f"{name} forward ({impl})")
    assert float(aux) == 0.0


@pytest.mark.parametrize("name", LM_ARCHS)
def test_teacher_forced_decode_matches_jax(lm_refs, name):
    """S decode steps from an empty cache: each step's logits and the
    cache they leave behind, leaf by leaf."""
    r = lm_refs(name)
    cfg = r["tcfg"]
    p = params_from_numpy(r["params"], "cpu")
    tokens = torch.as_tensor(r["tokens"]).long()
    cache = TT.init_cache(cfg, B, S, torch.float32, "cpu")
    for i in range(S):
        lg, cache = TT.decode_step(p, cache, tokens[:, i:i + 1], i, cfg)
        assert_close(lg[:, 0], r["dec"][:, i], f"{name} decode step {i}")
    jl = jax.tree.leaves(r["tf_cache"])
    tl = tree_leaves(cache)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert_close(a, b, f"{name} teacher-forced cache")
    # the serving step (a 0-d device position) through the JAX package's
    # teacher-forced prefill signature
    cache2 = TT.init_cache(cfg, B, S, torch.float32, "cpu")
    nxt, cache2 = teacher_forced_prefill(tsteps.make_serve_step(cfg), p,
                                         cache2, tokens)
    np.testing.assert_array_equal(nxt[:, 0].numpy(),
                                  r["dec"][:, -1].argmax(-1))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", LM_ARCHS)
def test_bulk_prefill_matches_jax(lm_refs, name, impl):
    """``make_bulk_prefill``: the next tokens identical and every cache
    leaf (K/V at their ring slots; conv tails and the final SSD state)
    within tolerance of the JAX package's bulk prefill, and of its
    teacher-forced cache."""
    r = lm_refs(name)
    cfg = r["tcfg"]
    p = params_from_numpy(r["params"], "cpu")
    cache = TT.init_cache(cfg, B, S, torch.float32, "cpu")
    bulk = tsteps.make_bulk_prefill(cfg, attn_chunk=8, impl=impl)
    nxt, cache = bulk(p, torch.as_tensor(r["tokens"]).long(), cache)
    np.testing.assert_array_equal(nxt.numpy(), r["next"])
    for a, b, c in zip(tree_leaves(cache), jax.tree.leaves(r["bulk_cache"]),
                       jax.tree.leaves(r["tf_cache"])):
        assert_close(a, b, f"{name} bulk cache ({impl})")
        assert_close(a, c, f"{name} bulk vs teacher-forced cache ({impl})")


# ---------------------------------------------------------------------------
# whisper
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def whisper_ref():
    jcfg = JARCHS["whisper-base"].reduced()
    rng = np.random.default_rng(1)
    Bw, Sw, SRC = 2, 12, 16
    params = jsteps.init_fn(jcfg)(jax.random.key(2))
    src = rng.normal(size=(Bw, SRC, jcfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (Bw, Sw)).astype(np.int32)
    enc = jencdec.encode(params, jnp.asarray(src), jcfg, attn_chunk=8)
    full = jencdec.decode_fwd(params, jnp.asarray(tokens), enc, jcfg,
                              attn_chunk=8)
    ck, cv = jencdec.cross_kv(params, enc, jcfg)
    loop = [(JL.dense(jax.tree.map(lambda x: x[i], params["dec_blocks"])
                      ["cross_attn"][w], enc)
             .reshape(Bw, SRC, jcfg.n_kv_heads, jcfg.hd))
            for i in range(jcfg.n_layers) for w in ("wk", "wv")]

    def fresh():
        c = jencdec.init_dec_cache(jcfg, Bw, Sw, SRC, jnp.float32)
        c["cross_k"], c["cross_v"] = ck, cv
        return c
    step = jax.jit(lambda p, c, t, i: jencdec.decode_step(p, c, t, i, jcfg))
    cache = fresh()
    dec = []
    for i in range(Sw):
        lg, cache = step(params, cache, jnp.asarray(tokens[:, i:i + 1]),
                         jnp.int32(i))
        dec.append(np.asarray(lg[:, 0]))
    nxt, bulk_cache = jax.jit(jsteps.make_bulk_prefill(jcfg, attn_chunk=8))(
        params, jnp.asarray(tokens), enc, fresh())
    return dict(cfg=TARCHS["whisper-base"].reduced(), params=_np(params),
                src=src, tokens=tokens, enc=np.asarray(enc),
                full=np.asarray(full), ck=np.asarray(ck), cv=np.asarray(cv),
                loop=[np.asarray(x) for x in loop], dec=np.stack(dec, 1),
                tf_cache=_np(cache), next=np.asarray(nxt),
                bulk_cache=_np(bulk_cache), shape=(Bw, Sw, SRC))


def _whisper_cache(r, p, enc):
    cfg = r["cfg"]
    Bw, Sw, SRC = r["shape"]
    cache = tencdec.init_dec_cache(cfg, Bw, Sw, SRC, torch.float32, "cpu")
    ck, cv = tencdec.cross_kv(p, enc, cfg)
    cache["cross_k"].copy_(ck)
    cache["cross_v"].copy_(cv)
    return cache, ck, cv


def test_whisper_encode_cross_kv_and_decode_fwd_match_jax(whisper_ref):
    r = whisper_ref
    cfg = r["cfg"]
    p = params_from_numpy(r["params"], "cpu")
    enc = tencdec.encode(p, torch.as_tensor(r["src"]), cfg, attn_chunk=8)
    assert_close(enc, r["enc"], "whisper encode")
    _, ck, cv = _whisper_cache(r, p, enc)
    assert_close(ck, r["ck"], "cross_k")
    assert_close(cv, r["cv"], "cross_v")
    # the stacked einsum equals the JAX package's per-layer loop
    for i in range(cfg.n_layers):
        assert_close(ck[i], r["loop"][2 * i], f"cross_k layer {i} vs loop")
        assert_close(cv[i], r["loop"][2 * i + 1], f"cross_v layer {i} vs loop")
    full = tencdec.decode_fwd(p, torch.as_tensor(r["tokens"]).long(), enc,
                              cfg, attn_chunk=8)
    assert_close(full, r["full"], "whisper decode_fwd")


@pytest.mark.parametrize("impl", IMPLS)
def test_whisper_bulk_prefill_and_decode_match_jax(whisper_ref, impl):
    r = whisper_ref
    cfg = r["cfg"]
    Bw, Sw, _ = r["shape"]
    p = params_from_numpy(r["params"], "cpu")
    enc = torch.tensor(r["enc"])
    tokens = torch.as_tensor(r["tokens"]).long()
    cache, _, _ = _whisper_cache(r, p, enc)
    nxt, cache = tsteps.make_bulk_prefill(cfg, attn_chunk=8, impl=impl)(
        p, tokens, enc, cache)
    np.testing.assert_array_equal(nxt.numpy(), r["next"])
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(r["bulk_cache"])):
        assert_close(a, b, f"whisper bulk cache ({impl})")
    tf, _, _ = _whisper_cache(r, p, enc)
    for i in range(Sw):
        lg, tf = tencdec.decode_step(p, tf, tokens[:, i:i + 1], i, cfg)
        assert_close(lg[:, 0], r["dec"][:, i], f"whisper decode step {i}")
    for a, b in zip(tree_leaves(tf), jax.tree.leaves(r["tf_cache"])):
        assert_close(a, b, "whisper teacher-forced cache")


@pytest.mark.parametrize("name", ("gemma3-12b", "mamba2-370m"))
def test_decode_position_as_a_device_tensor_matches_an_int(lm_refs, name):
    """The serving decoder's position is a 0-d tensor the step advances
    itself (what a captured graph reads): through the ring buffer's wrap
    and the SSM state it gives the logits and cache of an int position."""
    from repro_torch.launch.serve import Decoder
    r = lm_refs(name)
    cfg = r["tcfg"]
    p = params_from_numpy(r["params"], "cpu")
    tokens = torch.as_tensor(r["tokens"]).long()
    dec = Decoder(cfg, p, TT.init_cache(cfg, B, S, torch.float32, "cpu"), B,
                  "cpu")
    for i in range(S):
        dec.set(tokens[:, i:i + 1], i)
        dec.step()
        assert int(dec.index) == i + 1
        np.testing.assert_array_equal(dec.token[:, 0].numpy(),
                                      r["dec"][:, i].argmax(-1))
    for a, b in zip(tree_leaves(dec.cache), jax.tree.leaves(r["tf_cache"])):
        assert_close(a, b, f"{name} decoder cache")
