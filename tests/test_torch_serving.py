"""The port's serving layer against the JAX package's, on the CPU.

* ``launch/parambuf``: round trips for every supported arch and a
  mixed-dtype tree, ``LeafSpec``s and ``pack_np`` buffers equal to the JAX
  package's byte for byte on the same tree, ``unpack`` as views, and the
  in-place ``make_swap`` (same ``data_ptr``, the new values, a leaf that is
  its slot's view skipped);
* checkpoints in both layouts, bfloat16 included, written by either
  package and restored by the other;
* ``serve()`` on ``--reduced --device cpu``: on the JAX package's params,
  the JAX package's tokens for the same prompts;
* ``ContinuousServer`` on the JAX package's params and coupling: the JAX
  server's tokens; a swap that changes the bias; the hot-swap bit-identity
  against a fresh server; ``run_continuous`` beside a fused CPU experiment
  with no capture after warm-up.

Tolerances: bit-equal where the test says so; tokens identical.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.checkpoint import save_flat_checkpoint as jsave_flat
from repro.configs import ARCHS as JARCHS
from repro.launch import parambuf as jbuf
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.launch.continuous import ContinuousServer as JServer
from repro.models import paper_models as jpm
from repro_torch.checkpoint import (load_checkpoint, save_checkpoint,
                                    save_flat_checkpoint)
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.core.trees import tree_leaves, tree_map
from repro_torch.fl.runtime import MFLExperiment
from repro_torch.launch import parambuf, serve, steps
from repro_torch.launch.continuous import ContinuousServer, run_continuous

SERVED = ("qwen3-0.6b", "qwen3-4b", "qwen2-72b", "gemma3-12b", "mamba2-370m",
          "whisper-base")
#: a solve small enough for CPU rounds (the port's JCSBA on the CPU)
FAST_JCSBA = {"immune_kwargs": {"S": 6, "G": 2}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(name, seed=0):
    return _np(jsteps.init_fn(JARCHS[name].reduced())(jax.random.key(seed)))


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def _leaves(tree):
    """Leaves in ``jax.tree.leaves`` order, lists included."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_trees_bit_equal(got, want):
    """A tree of tensors or numpy arrays (bfloat16 in either form) against
    a JAX-side numpy tree: same structure order, shapes and bytes."""
    gl = [x if isinstance(x, np.ndarray) else x.detach()
          for x in _leaves(got)]
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if isinstance(g, torch.Tensor):
            g = (g.view(torch.int16).numpy() if g.dtype == torch.bfloat16
                 else g.numpy())
        assert tuple(g.shape) == tuple(np.shape(w))
        assert _bits(g) == _bits(np.asarray(w))


def _mixed_tree():
    return {
        "w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
        "step": jnp.int32(7),
        "half": jnp.ones((4,), jnp.bfloat16) * 1.5,
        "nested": [jnp.zeros((2,), jnp.float32),
                   jnp.array([1, 2], jnp.int32)],
    }


def _leafspecs(spec):
    return [tuple(ls) for ls in spec.leaves], tuple(spec.sizes)


# ---------------------------------------------------------------------------
# parambuf
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", SERVED)
def test_pack_unpack_roundtrip_and_layout_equal_jax(name):
    """The port's own params round-trip through the flat buffers as views;
    on the JAX package's params the port's spec and ``pack_np`` buffers
    equal the JAX package's byte for byte."""
    cfg = TARCHS[name].reduced()
    own = steps.init_fn(cfg)(torch.Generator().manual_seed(0))
    spec = parambuf.spec_of(own)
    bufs = parambuf.pack(own, spec)
    assert [dt for dt, _ in spec.sizes] == ["float32"]
    assert sum(n for _, n in spec.sizes) == steps.param_count(own)
    back = parambuf.unpack(bufs, spec)
    for a, b in zip(tree_leaves(back), tree_leaves(own)):
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() == \
            bufs["float32"].untyped_storage().data_ptr()
    assert parambuf.spec_of(steps.params_shape(cfg)) == spec

    jp = _jax_params(name)
    jnp_bufs, jspec = jbuf.pack_np(jp)
    for tree in (jp, params_from_numpy(jp, "cpu")):
        np_bufs, tspec = parambuf.pack_np(tree)
        assert _leafspecs(tspec) == _leafspecs(jspec)
        assert sorted(np_bufs) == sorted(jnp_bufs)
        for dt in jnp_bufs:
            assert _bits(np_bufs[dt]) == _bits(jnp_bufs[dt])
        _assert_trees_bit_equal(parambuf.unpack_np(np_bufs, tspec), jp)


def test_mixed_dtype_tree_matches_jax_layout():
    jt = _mixed_tree()
    jspec = jbuf.spec_of(jt)
    jbufs, _ = jbuf.pack_np(jt)
    tt = params_from_numpy({k: v for k, v in _np(jt).items()
                            if k != "nested"}, "cpu")
    tt["nested"] = [torch.zeros((2,)), torch.tensor([1, 2], dtype=torch.int32)]
    spec = parambuf.spec_of(tt)
    assert spec.n_buffers == 3
    assert dict(spec.sizes) == {"bfloat16": 4, "float32": 8, "int32": 3}
    assert _leafspecs(spec) == _leafspecs(jspec)
    hash(spec)
    np_bufs, _ = parambuf.pack_np(tt, spec)
    for dt in jbufs:
        assert _bits(np_bufs[dt]) == _bits(jbufs[dt])
    out = parambuf.unpack(parambuf.pack(tt, spec), spec)
    assert isinstance(out["nested"], list)
    _assert_trees_bit_equal(out, _np(jt))
    _assert_trees_bit_equal(parambuf.unpack_np(np_bufs, spec), _np(jt))


def test_make_swap_writes_in_place_and_skips_its_own_views():
    cfg = TARCHS["qwen3-0.6b"].reduced()
    params = steps.init_fn(cfg)(torch.Generator().manual_seed(0))
    spec = parambuf.spec_of(params)
    bufs = parambuf.pack(params, spec)
    ptrs = {dt: b.data_ptr() for dt, b in bufs.items()}
    views = parambuf.unpack(bufs, spec)
    swap = parambuf.make_swap(spec)

    new = tree_map(lambda x: x + 1.0, params)
    assert swap(bufs, new) is bufs
    assert swap.bytes_written == spec.nbytes()
    assert {dt: b.data_ptr() for dt, b in bufs.items()} == ptrs
    for v, n in zip(tree_leaves(views), tree_leaves(new)):
        assert torch.equal(v, n)            # the old views see the new values
    swap(bufs, views)                       # every leaf is its slot's view
    assert swap.bytes_written == 0
    half = dict(views, final_norm=views["final_norm"] * 0.5)
    swap(bufs, half)
    assert swap.bytes_written == 4 * cfg.d_model
    for _ in range(3):
        swap(bufs, tree_map(lambda x: x * 0.5, new))
    assert {dt: b.data_ptr() for dt, b in bufs.items()} == ptrs


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
def _bf16_tree():
    rng = np.random.default_rng(4)
    return {"blocks": {"w": np.asarray(jnp.asarray(rng.normal(size=(2, 3, 4)),
                                                   jnp.bfloat16)),
                       "s": rng.normal(size=(2, 3)).astype(np.float32)},
            "embed": np.asarray(jnp.asarray(rng.normal(size=(5, 4)),
                                            jnp.bfloat16)),
            "step": np.asarray(3, np.int32)}


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("tree_kind", ["mamba2-370m", "bf16"])
def test_checkpoints_restore_across_packages(tmp_path, layout, tree_kind):
    jp = _jax_params("mamba2-370m", 3) if tree_kind != "bf16" \
        else _bf16_tree()
    tp = params_from_numpy(jp, "cpu")
    tsave = save_flat_checkpoint if layout == "flat" else save_checkpoint
    jsv = jsave_flat if layout == "flat" else jsave
    tsave(str(tmp_path / "t"), tp, step=5, metadata={"by": "port"})
    jsv(str(tmp_path / "j"), jp, step=5, metadata={"by": "jax"})
    # the port's checkpoint in the JAX package, the JAX one in the port
    for load, path, by in ((jload, "t", "port"), (load_checkpoint, "j", "jax"),
                           (load_checkpoint, "t", "port")):
        tree, meta = load(str(tmp_path / path))
        assert meta["step"] == 5 and meta["metadata"]["by"] == by
        assert (meta.get("layout") == "flat") == (layout == "flat")
        _assert_trees_bit_equal(tree, jp)
        _assert_trees_bit_equal(params_from_numpy(tree, "cpu"), jp)
    # both manifests name the same keys, dtypes and shapes
    mt, mj = load_checkpoint(str(tmp_path / "t"))[1], \
        jload(str(tmp_path / "j"))[1]
    for k in ("keys", "dtypes", "shapes"):
        assert mt[k] == mj[k]
    if layout == "flat":
        assert mt["flat"] == mj["flat"]


# ---------------------------------------------------------------------------
# serve()
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,teacher", [("qwen3-0.6b", False),
                                          ("mamba2-370m", True),
                                          ("whisper-base", False)])
def test_serve_matches_jax_on_its_params(monkeypatch, capsys, name, teacher):
    """The same flags on both packages, the port serving the JAX package's
    params: the same prompts and source frames (one numpy draw), the same
    tokens."""
    flags = dict(arch=name, reduced=True, batch=2, prompt_len=8, gen_len=6,
                 attn_chunk=64, teacher_forced=teacher, seed=0)
    jout = np.asarray(jserve.serve(argparse.Namespace(**flags)))
    jp = _jax_params(name)
    monkeypatch.setattr(serve.S, "init_fn",
                        lambda cfg: lambda gen: params_from_numpy(jp, "cpu"))
    stats = {}
    out = serve.serve(argparse.Namespace(device="cpu", **flags), stats)
    np.testing.assert_array_equal(out.numpy(), jout)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve] arch=")]
    assert len(lines) == 2 and lines[1].split()[:5] == lines[0].split()[:5]
    assert stats["captures"] == 0 and len(stats["decode_ms"]) == 5


def test_serve_main_runs_on_the_cpu(capsys):
    out = serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--gen-len", "4"])
    assert out.shape == (2, 4)
    assert "[serve] arch=qwen3-0.6b batch=2 prefill=bulk" in \
        capsys.readouterr().out


# ---------------------------------------------------------------------------
# continuous serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_server_case():
    """The JAX package's ContinuousServer on its own params: its coupling,
    its tokens after prefill and after each of 6 decode steps."""
    cfg = JARCHS["qwen3-0.6b"].reduced()
    rng = np.random.default_rng(0)
    Bc, Sc, steps_ = 2, 12, 6
    feats = {"audio": rng.normal(size=(Bc, 20, 11)).astype(np.float32),
             "text": rng.normal(size=(Bc, 30, 100)).astype(np.float32)}
    fusion_a = jpm.init_iemocap_model(jax.random.key(10))
    fusion_b = jpm.init_iemocap_model(jax.random.key(11))
    lm = jsteps.init_fn(cfg)(jax.random.key(1))
    prompts = rng.integers(0, cfg.vocab_size, (Bc, Sc)).astype(np.int32)
    srv = JServer(cfg, lm, fusion_a, {m: jnp.asarray(x)
                                      for m, x in feats.items()},
                  max_len=Sc + 2 * steps_ + 2)
    bias_a = np.asarray(srv.bias)
    srv.start(jnp.asarray(prompts))
    toks = [np.asarray(srv.token)]
    for _ in range(steps_):
        srv.decode_step()
        toks.append(np.asarray(srv.token))
    srv.swap(fusion_b)
    for _ in range(steps_):
        srv.decode_step()
        toks.append(np.asarray(srv.token))
    coupling = np.asarray(jax.random.normal(
        jax.random.key(0), (10, cfg.vocab_size), jnp.float32) * 0.1)
    return dict(lm=_np(lm), fusion_a=_np(fusion_a), fusion_b=_np(fusion_b),
                feats=feats, prompts=prompts, tokens=np.stack(toks),
                coupling=coupling, bias=bias_a, steps=steps_,
                max_len=Sc + 2 * steps_ + 2)


def _server(case, fusion="fusion_a", **kw):
    return ContinuousServer(TARCHS["qwen3-0.6b"].reduced(), case["lm"],
                            case[fusion], case["feats"],
                            max_len=case["max_len"],
                            coupling=case["coupling"], device="cpu", **kw)


def test_continuous_server_matches_jax_server(jax_server_case):
    """The JAX package's params and coupling: the same bias, the same
    tokens after prefill, decode steps and a swap."""
    c = jax_server_case
    srv = _server(c)
    np.testing.assert_allclose(srv.bias.numpy(), c["bias"], rtol=1e-5,
                               atol=1e-5)
    srv.start(c["prompts"])
    toks = [srv.token.numpy().copy()]
    for _ in range(c["steps"]):
        srv.decode_step()
        toks.append(srv.token.numpy().copy())
    srv.swap(params_from_numpy(c["fusion_b"], "cpu"))
    for _ in range(c["steps"]):
        srv.decode_step()
        toks.append(srv.token.numpy().copy())
    np.testing.assert_array_equal(np.stack(toks), c["tokens"])
    assert srv.index == c["prompts"].shape[1] + 2 * c["steps"]
    assert srv.compile_counts() == {"decode_captures": 0}


def test_hot_swap_decode_is_bit_identical_to_fresh_engine(jax_server_case):
    """From the swap on, the tokens a fresh server with the new params
    restored to the same state produces."""
    c = jax_server_case
    srv = _server(c)
    srv.start(c["prompts"])
    for _ in range(3):
        srv.decode_step()
    st = srv.state()
    ptrs = {dt: b.data_ptr() for dt, b in srv.bufs.items()}
    srv.swap(params_from_numpy(c["fusion_b"], "cpu"))
    assert {dt: b.data_ptr() for dt, b in srv.bufs.items()} == ptrs
    swapped = []
    for _ in range(5):
        srv.decode_step()
        swapped.append(srv.token.clone())
    fresh = _server(c, fusion="fusion_b")
    fresh.load_state(st)
    for t in swapped:
        fresh.decode_step()
        assert torch.equal(fresh.token, t)


@pytest.fixture(scope="module")
def fused_cpu():
    """A reduced LM served beside IEMOCAP fused rounds on the CPU."""
    exp = MFLExperiment(dataset="iemocap", scheduler="jcsba", K=6,
                        n_samples=120, seed=0, eval_every=10 ** 9,
                        engine="fused:pallas", device="cpu",
                        scheduler_kwargs=FAST_JCSBA)
    cfg = TARCHS["qwen3-0.6b"].reduced()
    feats = {m: x[:2] for m, x in sorted(exp.test_ds.features.items())}
    lm = steps.init_fn(cfg)(torch.Generator().manual_seed(0))
    server = ContinuousServer(cfg, lm, exp.global_params, feats,
                              max_len=12 + 8 + 2 * 4, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    return exp, server, prompts


def test_swap_updates_serving_params(fused_cpu):
    exp, server, prompts = fused_cpu
    server.start(prompts)
    before = tree_map(torch.clone, server.params["fusion"])
    lm_before = tree_map(torch.clone, server.params["lm"])
    bias_before = server.bias.clone()
    exp.run_scanned(1)
    eng = exp._get_fused_engine()
    server.swap(eng.round_params(exp._carry))
    after = server.params
    assert any(not torch.equal(b, a) for b, a in
               zip(tree_leaves(before), tree_leaves(after["fusion"])))
    for a, b in zip(tree_leaves(lm_before), tree_leaves(after["lm"])):
        assert torch.equal(a, b)
    assert server.swap_bytes == 4 * sum(x.numel() for x in
                                        tree_leaves(after["fusion"]))
    assert float((server.bias - bias_before).abs().max()) > 0


def test_run_continuous_zero_recaptures(fused_cpu):
    exp, server, prompts = fused_cpu
    rounds, spr = 2, 4
    rep = run_continuous(exp, server, prompts, rounds=rounds,
                         steps_per_round=spr, warmup_steps=2)
    assert sum(rep["recompiles"].values()) == 0, rep["recompiles"]
    assert rep["compile_counts"] == {"decode_captures": 0}
    assert len(rep["swap_walls_s"]) == len(rep["round_walls_s"]) == rounds
    assert len(rep["post_swap_latencies_s"]) == rounds
    assert len(rep["steady_latencies_s"]) == rounds * (spr - 1)
    assert rep["tokens_decoded"] == server.batch * rounds * spr
    assert rep["tokens_per_s"] > 0 and rep["swap_bytes"] > 0


def test_audio_arch_and_mesh_rejected():
    feats = {"audio": np.zeros((1, 4, 11), np.float32)}
    with pytest.raises(NotImplementedError):
        ContinuousServer(TARCHS["whisper-base"].reduced(), {}, {}, feats,
                         max_len=8, device="cpu")
    # a mesh of another device type than the server's is refused
    cfg = TARCHS["qwen3-0.6b"].reduced()
    mesh = argparse.Namespace(device_type="cuda", mesh=torch.arange(2),
                              get_coordinate=lambda: [0])
    with pytest.raises(ValueError, match="of its device type"):
        ContinuousServer(cfg, {}, {}, feats, max_len=8, mesh=mesh,
                         device="cpu")
