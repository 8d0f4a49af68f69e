"""The port's LM-scale dry run (``repro_torch.launch.{specs,hlo_analysis,
dryrun}``) against the JAX package's.

* the input and cache shapes of every config x input shape against
  ``jax.eval_shape``'s, and their partition specs against the JAX
  package's functions on 16×16 and 2×16×16 stand-in meshes;
* ``hlo_analysis`` is a byte-for-byte copy;
* the collector: collectives DTensor issues on a 4-rank fake mesh give the
  ``summarize`` dict that hand-written ``CollectiveOp``s give;
* per-rank FLOPs of a sharded matmul equal the hand count;
* the mirror of ``tests/test_dryrun_mini.py``: reduced qwen3-0.6b's train
  step on an 8-rank 4×2 fake mesh, and the depth calibration's corrected
  count against the full-depth count (a subprocess), and the command line
  on the 256-rank production mesh at one super-block (a subprocess);
* the hill-climb levers leave the plain-tensor loss unchanged.

Fake groups of 2 and 4 ranks live in this process only for the test that
needs them; a larger one is made in a subprocess.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from _torch_cpu import one_torch_thread  # noqa: F401
from repro.configs import ARCHS as J_ARCHS
from repro.launch import hlo_analysis as jhlo
from repro.launch import sharding as jsh
from repro.launch import specs as jspecs
from repro_torch import dtensor_layouts as DL
from repro_torch.configs import ARCHS
from repro_torch.core.trees import tree_leaves
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as thlo
from repro_torch.launch import specs as S
from repro_torch.launch import steps as TS
from repro_torch.launch.sharding import P, _map_with_path, _path_str
from repro_torch.models import transformer as T

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


class _Mesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": _Mesh({"data": 16, "model": 16}),
          "2x16x16": _Mesh({"pod": 2, "data": 16, "model": 16})}


def _t(spec):
    return tuple(spec)


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jsh._path_str(p): leaf for p, leaf in flat}


def _torch_leaves(tree):
    out = {}
    _map_with_path(lambda p, leaf: out.__setitem__(_path_str(p), leaf), tree)
    return out


def _jax_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jsh._path_str(p): _t(s) for p, s in flat}


# ---------------------------------------------------------------------------
# (a) specs against the JAX package, every config x input shape
# ---------------------------------------------------------------------------
def test_input_shape_tables_equal_jax():
    assert {k: tuple(vars(v).values()) for k, v in S.INPUT_SHAPES.items()} \
        == {k: tuple(vars(v).values())
            for k, v in jspecs.INPUT_SHAPES.items()}
    assert (S.WHISPER_SRC_LEN, S.VLM_N_PATCHES, S.LONG_CONTEXT_OK) == \
        (jspecs.WHISPER_SRC_LEN, jspecs.VLM_N_PATCHES,
         jspecs.LONG_CONTEXT_OK)


@pytest.mark.parametrize("shape_name", sorted(S.INPUT_SHAPES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_batch_and_cache_specs_equal_jax(name, shape_name):
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    shape, jshape = S.INPUT_SHAPES[shape_name], \
        jspecs.INPUT_SHAPES[shape_name]
    assert S.supports(cfg, shape) == jspecs.supports(jcfg, jshape)
    trees = [(S.batch_specs(cfg, shape), jspecs.batch_specs(jcfg, jshape))]
    if shape.kind == "decode":
        trees.append((S.cache_specs(cfg, shape),
                      jspecs.cache_specs(jcfg, jshape)))
    for got, want in trees:
        got, want = _torch_leaves(got), _jax_leaves(want)
        assert sorted(got) == sorted(want)
        for path, leaf in got.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(want[path].shape), path
            assert str(leaf.dtype).removeprefix("torch.") == \
                str(want[path].dtype), path
    for mesh in MESHES.values():
        got = S.batch_pspecs(cfg, shape, mesh)
        assert _torch_leaves(got) == _jax_specs(
            jspecs.batch_pspecs(jcfg, jshape, mesh))
        if shape.kind == "decode":
            got = S.cache_pspecs(S.cache_specs(cfg, shape), cfg, shape, mesh)
            want = jspecs.cache_pspecs(jspecs.cache_specs(jcfg, jshape),
                                       jcfg, jshape, mesh)
            assert _torch_leaves(got) == _jax_specs(want)


# ---------------------------------------------------------------------------
# (b) the numpy-only copy
# ---------------------------------------------------------------------------
def test_hlo_analysis_is_a_byte_for_byte_copy():
    with open(jhlo.__file__, "rb") as a, open(thlo.__file__, "rb") as b:
        assert a.read() == b.read()
    text = ("ENTRY main {\n"
            "  %ag = bf16[64,128] all-gather(bf16[16,128] %x), "
            "replica_groups=[4,4]<=[16]\n}\n")
    for mod in (jhlo, thlo):
        ops = mod.parse_collectives(text)
        assert mod.summarize(ops)["bytes_by_kind"] == \
            {"all-gather": 64 * 128 * 2 // 4}


# ---------------------------------------------------------------------------
# (c), (d): a fake group of 2 or 4 ranks in this process
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_group(request):
    D.fake_world(request.param)
    yield request.param
    dist.destroy_process_group()


def _mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names)


@pytest.mark.parametrize("fake_group", [4], indirect=True)
def test_collector_gives_the_summary_of_hand_written_ops(fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    mesh = _mesh((2, 2), ("data", "model"))
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(8, 16), mesh,
                              [Shard(0), Replicate()])        # [4,16] local
        part = DTensor.from_local(torch.empty(8, 16), mesh,
                                  [Replicate(), Partial()], run_check=False)
        b = torch.empty(4, 16)
        counter = D.StepCounter(mesh)
        with counter:
            x.redistribute(mesh, [Replicate(), Replicate()])   # all-gather
            part.redistribute(mesh, [Replicate(), Replicate()])  # all-reduce
            part.redistribute(mesh, [Replicate(), Shard(0)])   # red.-scatter
            funcol.broadcast(b, 0, mesh.get_group("model"))
    f32 = 4
    want = [thlo.CollectiveOp("all-gather", "data", 8 * 16 * f32, 2,
                              4 * 16 * f32, 1),
            thlo.CollectiveOp("all-reduce", "model", 8 * 16 * f32, 2,
                              8 * 16 * f32, 1),
            thlo.CollectiveOp("reduce-scatter", "model", 4 * 16 * f32, 2,
                              8 * 16 * f32, 1),
            thlo.CollectiveOp("broadcast", "model", 4 * 16 * f32, 2,
                              4 * 16 * f32, 1)]
    got = D.collect(counter.log)
    assert got == want
    assert thlo.summarize(got) == thlo.summarize(want)
    assert thlo.summarize(got)["op_counts"] == {
        "all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
        "broadcast": 1}


@pytest.mark.parametrize("fake_group", [2], indirect=True)
def test_per_rank_flops_of_a_sharded_matmul_are_the_hand_count(fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = _mesh((2,), ("data",))
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(8, 32), mesh, [Shard(0)])
        w = distribute_tensor(torch.empty(32, 16), mesh, [Replicate()])
        wk = distribute_tensor(torch.empty(32, 16), mesh, [Shard(0)])
        # the sharding propagator's own runs of the op (first call only)
        # must not count: the second call counts the same
        for _ in range(2):
            counter = D.StepCounter(mesh)
            with counter:
                x @ w
            assert counter.flops_local == 2 * 4 * 32 * 16
            assert counter.flops_global == 2 * 8 * 32 * 16
            assert counter.log == []
        counter = D.StepCounter(mesh)
        with counter:
            (x @ wk).sum()          # w gathered over the rows first
        assert counter.flops_local == 2 * 4 * 32 * 16
        assert [op.kind for op in D.collect(counter.log)] == ["all-gather"]


# ---------------------------------------------------------------------------
# (e), (f): the mini dry run and the calibration, 8 ranks (4x2)
# ---------------------------------------------------------------------------
_MINI = r"""
import json, math
import torch
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D, mesh as M, specs, sharding as shd
from repro_torch.core.trees import tree_leaves

D.fake_world(8)
mesh = M.make_debug_mesh(4, 2, device="cpu")
cfg = get_config("qwen3-0.6b").reduced()
shape = specs.InputShape("mini", 128, 8, "train")
fn, args, info = D.lower_combo("qwen3-0.6b", shape, cfg_override=cfg,
                               mesh=mesh, device="cpu")
rec = D.analyse(fn, args, info)
rec["status"] = "ok"

# rank 0's argument bytes from the specs alone
sizes = {"data": 4, "model": 2}
def shard_bytes(meta, spec):
    n = meta.numel() * meta.element_size()
    for ax in spec:
        if ax is not None:
            n //= math.prod(sizes[a] for a in (ax if isinstance(ax, tuple)
                                               else (ax,)))
    return n
from repro_torch.launch import steps
pshape = steps.params_shape(cfg)
pspecs = shd.tree_pspecs(pshape, ("data",), mesh=mesh)
opt, _ = steps.make_optimizer(cfg)
with torch.device("meta"):
    oshape = opt.init(pshape)
ospecs = shd.sanitize_tree(shd.opt_state_pspecs(oshape, pshape, ("data",)),
                           oshape, mesh)
bshape = specs.batch_specs(cfg, shape)
bspecs = specs.batch_pspecs(cfg, shape, mesh)
want = sum(shard_bytes(m, s) for t, ts in ((pshape, pspecs),
                                           (oshape, ospecs),
                                           (bshape, bspecs))
           for m, s in zip(tree_leaves(t), tree_leaves(ts)))
rec["want_argument_bytes"] = want

full = D.cut_depth(cfg, 3)
whole = D.analyse(*D.lower_combo("qwen3-0.6b", shape, cfg_override=full,
                                 mesh=mesh, device="cpu"))
cal = D.depth_counts(full, shape, mesh=mesh, device="cpu")
rec["calib"] = {"full_flops": whole["counted_flops_per_rank"],
                "full_bytes": whole["counted_bytes_per_rank"], **cal}
print(json.dumps(rec))
"""


def _run(script, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", script, *args], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


def test_mini_dryrun_and_calibration_on_an_8_rank_mesh():
    rec = json.loads(_run(_MINI).stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["n_devices"] == 8
    assert rec["mesh"] == "4x2" and rec["optimizer"] == "adamw"
    assert rec["counted_flops_per_rank"] > 0
    assert rec["counted_flops_per_rank"] < rec["counted_flops_global"]
    assert rec["collectives"]["n_sites"] > 0
    assert rec["collectives"]["total_operand_bytes"] > 0
    assert rec["argument_size_in_bytes"] == rec["want_argument_bytes"]
    assert rec["output_size_in_bytes"] > 0
    cal = rec["calib"]
    assert cal["n_units"] == 3
    assert cal["c2"]["flops"] > cal["c1"]["flops"] > 0
    # eager counting sees every layer: the depth correction is exact
    assert cal["corrected"]["flops"] == cal["full_flops"]


def test_command_line_on_the_production_mesh(tmp_path):
    r = _run("from repro_torch.launch.dryrun import main; main()",
             "--device", "cpu", "--arch", "qwen3-0.6b", "--shape",
             "decode_32k", "--blocks", "1", "--out", str(tmp_path))
    assert "[dryrun] qwen3-0.6b__decode_32k__16x16__blocks1: ok" in r.stdout
    rec = json.loads((tmp_path /
                      "qwen3-0.6b__decode_32k__16x16__blocks1.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert 0 < rec["counted_flops_per_rank"] < rec["counted_flops_global"]
    assert rec["collectives"]["n_sites"] > 0
    assert "hlo_flops" not in rec


def test_import_sets_no_environment_and_makes_no_group():
    r = _run("import os; before = dict(os.environ)\n"
             "import torch.distributed as dist\n"
             "import repro_torch.launch.dryrun\n"
             "assert dict(os.environ) == before\n"
             "assert not dist.is_initialized()\n"
             "print('clean')")
    assert r.stdout.strip() == "clean"


def test_plain_paths_do_not_load_dtensor():
    """The layout rules (``dtensor_layouts``) leave ``torch.distributed.
    tensor`` unloaded on the plain paths: with it imported in the process,
    a later CUDA-graph capture of the SSD fused round was invalidated on
    the card.  A DTensor is still seen once its maker has loaded it."""
    r = _run("import sys\n"
             "import repro_torch.fl.runtime, repro_torch.launch.train\n"
             "import repro_torch.launch.serve, repro_torch.launch.continuous\n"
             "from repro_torch import dtensor_layouts as DL\n"
             "assert 'torch.distributed.tensor' not in sys.modules\n"
             "import torch\n"
             "assert not DL.is_dtensor(torch.zeros(2))\n"
             "from repro_torch.launch.dryrun import fake_world\n"
             "from torch.distributed.device_mesh import init_device_mesh\n"
             "from torch.distributed.tensor import Replicate, "
             "distribute_tensor\n"
             "fake_world(2)\n"
             "mesh = init_device_mesh('cpu', (2,))\n"
             "t = distribute_tensor(torch.zeros(2), mesh, [Replicate()])\n"
             "assert DL.is_dtensor(t)\n"
             "print('clean')")
    assert r.stdout.strip() == "clean"


def test_entry_point_raises_without_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.main(["--arch", "qwen3-0.6b", "--shape", "train_4k"])


# ---------------------------------------------------------------------------
# (g) the hill-climb levers on plain tensors
# ---------------------------------------------------------------------------
def _batch(cfg, rng, B=2, S=64):
    b = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
         for k in ("tokens", "labels")}
    if cfg.arch_type == "vlm":
        b["patches"] = torch.as_tensor(
            rng.normal(size=(B, 8, cfg.frontend_dims[0])), dtype=torch.float32)
    return b


def _params(cfg):
    return TS.init_fn(cfg)(torch.Generator().manual_seed(0))


def test_residual_spec_and_tp_off_leave_the_plain_loss_unchanged():
    cfg = ARCHS["qwen3-0.6b"].reduced()
    params, batch = _params(cfg), _batch(cfg, np.random.default_rng(0))
    l0 = TS.make_loss_fn(cfg, attn_chunk=32)(params, batch)
    for spec in ((Shard(1), Shard(2)), (Replicate(), Replicate())):
        l1 = TS.make_loss_fn(cfg, attn_chunk=32, residual_spec=spec)(
            params, batch)
        assert torch.equal(l0, l1)
    x = torch.randn(1, 2, 4, 8)
    assert DL.constrain(x, (Shard(1), Shard(2))) is x
    specs = {"a": P(("data", "model"), None), "b": P("model", "data"),
             "c": P(None, ("pod", "data"))}
    assert D._strip_axis(specs, "model") == {
        "a": P(("data",), None), "b": P(None, "data"),
        "c": P(None, ("pod", "data"))}
    assert D._strip_axis(specs, "data") == {
        "a": P(("model",), None), "b": P("model", None),
        "c": P(None, ("pod",))}


@pytest.mark.parametrize("name", ["qwen3-0.6b", "mamba2-370m",
                                  "llava-next-34b"])
def test_loss_chunk_preserves_loss(name):
    cfg = ARCHS[name].reduced()
    params, batch = _params(cfg), _batch(cfg, np.random.default_rng(0))
    l0 = float(TS.make_loss_fn(cfg, attn_chunk=32)(params, batch))
    l1 = float(TS.make_loss_fn(cfg, attn_chunk=32, loss_chunk=16)(
        params, batch))
    assert l0 == pytest.approx(l1, rel=1e-5)


def test_remat_preserves_loss_and_grads():
    cfg = ARCHS["qwen3-0.6b"].reduced()
    params, batch = _params(cfg), _batch(cfg, np.random.default_rng(0))
    l0, g0 = TS.value_and_grad(TS.make_loss_fn(cfg, attn_chunk=32), params,
                               batch)
    l1, g1 = TS.value_and_grad(TS.make_loss_fn(cfg, attn_chunk=32,
                                               remat=True), params, batch)
    assert float(l0) == pytest.approx(float(l1), rel=1e-6)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_attn_chunk_invariance():
    cfg = ARCHS["gemma3-12b"].reduced()
    params = _params(cfg)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    l8, _ = T.forward(params, tokens, cfg, attn_chunk=8)
    l32, _ = T.forward(params, tokens, cfg, attn_chunk=32)
    torch.testing.assert_close(l8.float(), l32.float(), rtol=2e-4,
                               atol=2e-4)
