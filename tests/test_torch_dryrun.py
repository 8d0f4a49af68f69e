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
* the hill-climb levers leave the plain-tensor loss unchanged;
* the per-rank temporary peak against a hand count on a 2-rank mesh;
* the combos that need the decode step's split softmax and the MoE
  dispatch split over ranks (gemma3-12b and jamba-v0.1-52b long_500k,
  jamba-v0.1-52b train_4k, llama4-scout-17b-a16e train_4k's per-rank
  share) on the 256-rank production mesh at one super-block (a
  subprocess);
* the split dispatch's values: the MoE layer on DTensors of a real 2×2
  gloo mesh (4 rank subprocesses) against the plain path on the same
  numbers — output, the aux loss (the mean over all groups) and every
  gradient;
* per-rank FLOPs against the JAX package's compile (``hlo_flops``) on
  small meshes where the port once split unevenly: 2 KV heads on a 4×4
  mesh, and 2 sequences a data shard on a 16-rank model axis (the
  2×16×16 train steps' case), each side in a subprocess; and on the
  production meshes, one super-block with attention in one chunk, the
  batched products and the rest a rank against the compile's dots a
  device: qwen3-0.6b against a live compile (which equals
  ``tests/data/dryrun_jax_dots.json``), the ``_BAND_COMBOS`` against
  that file (train_4k, prefill_32k, the decode steps and a long_500k);
* the head-split layouts (``attend``, ``by_heads``, ``unsplit_matmul``)
  on 4 gloo ranks against the plain path, values and gradients; so too
  the decode step's router, the LM head and projection whose
  contraction moves to the model ranks, and mamba layers in a row;
* the vocab-split log-sum-exp, gold logit and masked embedding lookup on
  4 gloo ranks against the plain ops, values and gradients; the
  log-sum-exp's peak on 2 fake ranks against a hand count (no [.., V]
  gather); ``StepCounter`` counting no bytes for ops that move none.

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


@pytest.mark.parametrize("fake_group", [2], indirect=True)
def test_peak_bytes_per_rank_are_the_hand_count(fake_group):
    """Storages that local ops make count from the op to their release;
    views, in-place updates and the arguments add nothing; a
    collective's result counts once, its wait handing it on."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = _mesh((2,), ("data",))
    f32 = 4
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(8, 32), mesh, [Shard(0)])
        w = distribute_tensor(torch.empty(32, 16), mesh, [Replicate()])
        # the sharding propagator's own runs (first pass only) add nothing
        for _ in range(2):
            counter = D.StepCounter(mesh)
            counter.exclude((x, w))
            seen = []
            with counter:
                y = x @ w                              # [4, 16] local
                seen.append(counter.live_bytes)
                z = y * 2
                seen.append(counter.live_bytes)
                del y
                seen.append(counter.live_bytes)
                z.add_(1)
                z.to_local()[1:]
                seen.append(counter.live_bytes)
                g = x.redistribute(mesh, [Replicate()])   # [8, 32] gathered
                seen.append(counter.live_bytes)
                del g, z
                seen.append(counter.live_bytes)
            one = 4 * 16 * f32
            assert seen == [one, 2 * one, one, one, one + 8 * 32 * f32, 0]
            assert counter.peak_bytes == one + 8 * 32 * f32
            assert [op.kind for op in D.collect(counter.log)] == \
                ["all-gather"]


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
    assert rec["counted_peak_bytes_per_rank"] > 0
    assert "hlo_flops" not in rec


_REPAIRED = r"""
import json, sys
from repro_torch.launch import dryrun as D
D.fake_world(256)
out = {}
for arch, shape, levers in (("gemma3-12b", "long_500k", None),
                            ("jamba-v0.1-52b", "long_500k", None),
                            ("jamba-v0.1-52b", "train_4k", None),
                            ("llama4-scout-17b-a16e", "train_4k",
                             {"attn_chunk": 4096})):
    rec = D.run_one(arch, shape, False, force=True, out_dir=sys.argv[1],
                    device="cpu", blocks=1, overrides=levers)
    out[f"{arch} {shape}"] = {k: rec.get(k) for k in (
        "status", "error", "counted_flops_per_rank", "counted_flops_global",
        "counted_batched_flops_per_rank", "counted_peak_bytes_per_rank",
        "argument_size_in_bytes")}
print(json.dumps(out))
"""


def test_repaired_combos_on_the_production_mesh(tmp_path):
    """The decode step against a cache whose sequence the data and model
    axes split at once (long_500k, B=1), Jamba's training step, and the
    MoE dispatch split over ranks: each comes out ``ok`` with a per-rank
    peak; llama4-scout's train step (attention in one chunk: 40 query
    heads over 8 groups of 2 model ranks, each pair splitting its batch;
    the experts over ``model`` on every group) does a rank's work of the
    JAX compile's to 10 %, its batched products and the rest apart
    (``tests/data/dryrun_jax_dots.json``)."""
    out = json.loads(_run(_REPAIRED, str(tmp_path)).stdout.strip()
                     .splitlines()[-1])
    for name, rec in out.items():
        assert rec["status"] == "ok", (name, rec["error"])
        assert rec["counted_peak_bytes_per_rank"] > 0, name
        assert 0 < rec["counted_flops_per_rank"] < rec["counted_flops_global"]
    _hold(out["llama4-scout-17b-a16e train_4k"],
          _reference()["llama4-scout-17b-a16e"]["train_4k"]["16x16"], 0.10)


_MOE_RANKS = r"""
import numpy as np
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.convert import params_from_numpy
from repro_torch.core.trees import tree_leaves, tree_map
from repro_torch.launch import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import moe_apply
from test_torch_moe import _plain_case

cfg = ModelConfig(name="t", arch_type="moe", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                  n_experts=4, top_k=2, expert_d_ff=48, n_shared_experts=1,
                  capacity_factor=1.25, dtype="float32")
params, x, cot = _plain_case()
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
tp = params_from_numpy(params, "cpu")
specs = shd.tree_pspecs({"ffn": tp}, ("data",), mesh=mesh)["ffn"]
dp = tree_map(lambda t, s: distribute_tensor(
    t.clone(), mesh, shd.to_placements(s, mesh)).requires_grad_(), tp, specs)
rows = [Shard(0), Replicate()]
xd = distribute_tensor(torch.as_tensor(x), mesh, rows).requires_grad_()
with implicit_replication():
    y, aux = moe_apply(dp, xd, cfg, n_groups=4)
    cotd = distribute_tensor(torch.as_tensor(cot), mesh, rows)
    loss = (y * cotd).sum() + aux
    grads = torch.autograd.grad(loss, tree_leaves(dp) + [xd])
leaves = [t.requires_grad_() for t in tree_leaves(tp)]
tx = torch.as_tensor(x).requires_grad_()
y0, aux0 = moe_apply(tp, tx, cfg, n_groups=4)
grads0 = torch.autograd.grad((y0 * torch.as_tensor(cot)).sum() + aux0,
                             leaves + [tx])


def err(a, b):
    b = b.detach()
    return [float((a.full_tensor().detach() - b).abs().max()),
            float(b.abs().max())]


# the decode step's forms over a dim split over both mesh dims (a
# long_500k cache's keys): softmax, and argmax with a tie (first wins)
from repro_torch import dtensor_layouts as DL
g = torch.Generator().manual_seed(1)
s = torch.randn(2, 3, 16, generator=g)
s[1, 2, 5] = s[1, 2, 12] = s[1, 2].max() + 1.0
sd = distribute_tensor(s, mesh, [Shard(2), Shard(2)])
with implicit_replication():
    w, top = DL.softmax(sd), DL.argmax(sd)
emit({"y": err(y, y0), "aux": err(aux, aux0),
      "grads": [err(a, b) for a, b in zip(grads, grads0)],
      "wg_local": list(dp["wg"].to_local().shape),
      "softmax": err(w, torch.softmax(s, -1)),
      "argmax": top.full_tensor().tolist(),
      "argmax_want": s.argmax(-1).tolist()})
"""


def test_split_moe_dispatch_equals_the_plain_path(tmp_path):
    """The dry run's MoE layer (each rank routes its own groups, the
    experts split over ``model``) on real numbers: 4 gloo ranks on a 2×2
    data × model mesh, 4 groups, capacity drops and a shared expert; the
    output, the aux loss and every gradient equal the plain path's at the
    layer tolerance of ``tests/test_torch_moe.py``, on every rank.  The
    decode step's split softmax and argmax on the same ranks equal
    ``torch.softmax`` (same tolerance) and ``argmax`` (first of a tie)."""
    from _torch_ranks import Ranks
    for out in Ranks(_MOE_RANKS, 4, str(tmp_path)).results():
        assert out["wg_local"] == [2, 16, 48]     # E over model, D over data
        for what, (e, m) in [("y", out["y"]), ("aux", out["aux"]),
                             ("softmax", out["softmax"])] + [
                (f"grad {i}", g) for i, g in enumerate(out["grads"])]:
            assert e <= 1e-5 * max(1.0, m), (what, e, m)
        assert out["argmax"] == out["argmax_want"]
        assert out["argmax"][1][2] == 5


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


# ---------------------------------------------------------------------------
# (h) per-rank FLOPs against the JAX compile on small meshes
# ---------------------------------------------------------------------------
# one super-block of qwen3-0.6b with ``n_kv_heads`` KV heads, a train
# step of B sequences of S tokens on a ("data", "model") mesh; each side
# prints its per-rank FLOPs
_JAX_SMALL = r"""
import json, os, sys
os.environ["_REPRO_EXTRA_XLA"] = ""
sys.path.insert(0, sys.argv[2])
from dryrun_vs_jax import compile_record
dims, B, S, kv = json.loads(sys.argv[1])
print(json.dumps(compile_record("qwen3-0.6b", ("small", S, B, "train"),
                                mesh=dims, cfg_kw={"n_kv_heads": kv})
                 ["hlo_flops"]))
"""

_PORT_SMALL = r"""
import dataclasses, json, math, sys
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D, specs
dims, B, S, kv = json.loads(sys.argv[1])
D.fake_world(math.prod(dims))
mesh = DeviceMesh("cpu", torch.arange(math.prod(dims)).reshape(dims),
                  mesh_dim_names=("data", "model"))
cfg = dataclasses.replace(D.cut_depth(get_config("qwen3-0.6b"), 1),
                          n_kv_heads=kv)
fn, args, info = D.lower_combo(
    "qwen3-0.6b", specs.InputShape("small", S, B, "train"),
    cfg_override=cfg, mesh=mesh, device="cpu")
print(json.dumps(D.analyse(fn, args, info)["counted_flops_per_rank"]))
"""


def _start(script, *args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", script, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _last_json(p, timeout=120):
    try:
        out, err = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("dims, batch, kv_heads", [
    ((4, 4), 16, 2),     # 2 KV heads: fewer than the model axis's 4 ranks
    ((4, 16), 8, 8),     # 2 sequences a data shard, 16 model ranks
], ids=["4x4-kv2", "4x16-b8"])
def test_per_rank_flops_match_the_jax_compile_on_small_meshes(
        dims, batch, kv_heads):
    """The port's ``counted_flops_per_rank`` over the JAX package's
    ``hlo_flops`` for the same step on as many forced host devices lies in
    [0.85, 1.05], the band of the meshes that split evenly (the port counts
    matmul-class ops only, so it reads a few per cent low).  The two cases
    are the layouts that split unevenly before the dry run's rules
    (``dtensor_layouts``) took them: a rank then did 1.38× (4×4, 2 KV
    heads: partial sums leaking into the MLP) and 2.98× (4×16, fewer
    sequences a data shard than model ranks: attention repeated on every
    model rank) the reference's work."""
    arg = json.dumps([list(dims), batch, 512, kv_heads])
    jax_p = _start(_JAX_SMALL, arg, os.path.join(os.path.dirname(SRC),
                                             "tools"))
    port_p = _start(_PORT_SMALL, arg)
    port, ref = _last_json(port_p), _last_json(jax_p)
    assert 0.85 <= port / ref <= 1.05, (port, ref, port / ref)


_JAX_PROD = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
from dryrun_vs_jax import compile_record
print(json.dumps({s: compile_record("qwen3-0.6b", s, mesh="16x16",
                                    overrides={"attn_chunk": n})
                  for s, n in (("train_4k", 4096), ("prefill_32k", 32768))}))
"""

_PORT_PROD = r"""
import json
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
D.fake_world(256)
cfg = D.cut_depth(get_config("qwen3-0.6b"), 1)
out = {}
for s, n in (("train_4k", 4096), ("prefill_32k", 32768)):
    rec = D.analyse(*D.lower_combo("qwen3-0.6b", s, cfg_override=cfg,
                                   overrides={"attn_chunk": n},
                                   device="cpu"))
    out[s] = {k: rec[k] for k in ("counted_flops_per_rank",
                                  "counted_batched_flops_per_rank",
                                  "counted_flops_global")}
print(json.dumps(out))
"""

# the JAX compile's dot FLOPs a device, written by ``tools/dryrun_vs_jax.py
# --write`` (one super-block, one attention chunk)
REFERENCE = os.path.join(os.path.dirname(__file__), "data",
                         "dryrun_jax_dots.json")


def _reference():
    with open(REFERENCE) as f:
        return json.load(f)["combos"]


def _hold(rec, ref, band):
    """A port record's batched products and the rest a rank against the
    JAX compile's dots a device, each within ``band`` (a fraction)."""
    batched = rec["counted_batched_flops_per_rank"]
    other = rec["counted_flops_per_rank"] - batched
    for what, got, want in (("batched", batched, ref["batched_dot_flops"]),
                            ("other", other, ref["other_dot_flops"])):
        assert abs(got / want - 1) <= band, (what, got, want, got / want)


def test_per_rank_flops_against_the_jax_compile_on_the_production_mesh():
    """qwen3-0.6b at one super-block on 16×16, train_4k and prefill_32k,
    attention in one chunk (``attn_chunk`` = the sequence, so XLA's count
    has no loop body seen once): a rank's FLOPs in the batched products
    (attention's) and in the rest equal the JAX compile's dots a device to
    5 % — attention with every sequence on each rank and the heads over
    the 16 model ranks, the k and v gradients on half of hd a rank, as
    XLA lays it out (qwen3-0.6b prefill_32k read 1/15 of XLA's before).
    The live compile equals ``tests/data/dryrun_jax_dots.json``'s counts,
    so the file is the current JAX package's."""
    jax_p = _start(_JAX_PROD, os.path.join(os.path.dirname(SRC), "tools"))
    port_p = _start(_PORT_PROD)
    port, ref = _last_json(port_p), _last_json(jax_p)
    table = _reference()["qwen3-0.6b"]
    for shape in ("train_4k", "prefill_32k"):
        p, j = port[shape], ref[shape]
        assert j == table[shape]["16x16"], (shape, j, table[shape])
        _hold(p, j, 0.05)
        assert p["counted_flops_per_rank"] < p["counted_flops_global"]


# one super-block, attention in one chunk (a decode step has none):
# (arch, shape, band) on 16×16, then on 2×16×16, each mesh's combos in
# one subprocess
_BAND_COMBOS = {
    "16x16": (("qwen3-0.6b", "prefill_32k", 0.05),
              ("qwen3-4b", "prefill_32k", 0.05),
              ("whisper-base", "train_4k", 0.10),
              ("mamba2-370m", "prefill_32k", 0.10),
              ("llama4-scout-17b-a16e", "prefill_32k", 0.10),
              ("whisper-base", "decode_32k", 0.05),
              ("mamba2-370m", "decode_32k", 0.05),
              ("llama4-scout-17b-a16e", "decode_32k", 0.05),
              ("kimi-k2-1t-a32b", "decode_32k", 0.05),
              ("jamba-v0.1-52b", "prefill_32k", 0.10),
              ("jamba-v0.1-52b", "long_500k", 0.10)),
    "2x16x16": (("qwen3-0.6b", "prefill_32k", 0.05),
                ("kimi-k2-1t-a32b", "decode_32k", 0.05)),
}

_PORT_BAND = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
multi, combos = sys.argv[1] == "2x16x16", json.loads(sys.argv[2])
D.fake_world(512 if multi else 256)
chunk = {"train_4k": 4096, "prefill_32k": 32768}
out = {}
for arch, shape, _ in combos:
    rec = D.analyse(*D.lower_combo(
        arch, shape, multi_pod=multi,
        cfg_override=D.cut_depth(get_config(arch), 1),
        overrides={"attn_chunk": chunk[shape]} if shape in chunk else None,
        device="cpu"))
    out[f"{arch} {shape}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def band_records():
    procs = {m: _start(_PORT_BAND, m, json.dumps(c))
             for m, c in _BAND_COMBOS.items()}
    return {m: _last_json(p, timeout=300) for m, p in procs.items()}


@pytest.mark.parametrize("mesh, arch, shape, band", [
    (m, a, s, b) for m, combos in _BAND_COMBOS.items() for a, s, b in combos],
    ids=lambda v: str(v))
def test_per_rank_flops_in_the_band_of_the_jax_compile(band_records, mesh,
                                                        arch, shape, band):
    """The port's batched products and the rest a rank, at one super-block
    and one attention chunk, against the JAX compile's dots a device
    (``tests/data/dryrun_jax_dots.json``): within 5 % for the dense archs
    and the decode steps, 10 % for llama4-scout (40 query heads, the
    experts), whisper-base (8 heads on 16 model ranks, the encoder's and
    the cross-attention's batch kept split, the 51865-word vocab whole on
    every model rank), mamba2-370m (the SSD scan's heads over ``model``,
    C·Bᵀ whole on every rank) and jamba-v0.1-52b.  qwen3-0.6b prefill_32k
    on 16×16 read 1/15 of the reference's dots where attention split over
    every rank; the decode steps' rest read 13.737× and 14.366×
    (whisper-base, mamba2-370m: the LM head, and mamba2's B and C
    projections, repeated on the 16 model ranks), 1.014× and 1.479×
    (llama4-scout, kimi-k2: the router on the whole batch on every
    rank), and 1.991× for kimi-k2 on 2×16×16; jamba-v0.1-52b
    prefill_32k's 1.311× under torch 2.13 (a mamba layer's projections
    on a partial sum over ``model``)."""
    _hold(band_records[mesh][f"{arch} {shape}"],
          _reference()[arch][shape][mesh], band)


_HEADS_RANKS = r"""
import numpy as np
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import dtensor_layouts as DL
from repro_torch.models.layers import chunked_attention
from repro_torch.models.mamba2 import ssd_chunked

mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
rng = np.random.default_rng(0)


def t(*shape):
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)


def place(x, *pls):
    return distribute_tensor(x, mesh, list(pls)).requires_grad_()


def errs(fn, plain_args, placed, cot):
    with implicit_replication():
        o = fn(*placed)
        g = torch.autograd.grad(
            (o * distribute_tensor(cot, mesh, o.placements)).sum(), placed)
    xs = [a.clone().requires_grad_() for a in plain_args]
    o0 = fn(*xs)
    g0 = torch.autograd.grad((o0 * cot).sum(), xs)
    return [float((o.full_tensor() - o0).abs().max()),
            float(o0.abs().max())] + [
        float((a.full_tensor() - b).abs().max()) for a, b in zip(g, g0)]


out = {}
# (B, S, H, KV, hd, window, causal, keep_batch): heads aligned with the
# model ranks; 1 KV head (the k/v gradients on an hd slice a rank); 3
# heads (blocks of a batch split); B=1 (ranks repeating a block); the
# encoder's batch kept split
for name, (B, S, H, KV, hd, window, causal, keep) in {
        "aligned": (2, 8, 4, 2, 4, None, True, False),
        "sliced": (2, 8, 4, 1, 4, None, True, False),
        "sliced_window": (2, 8, 4, 1, 4, 3, True, False),
        "blocks": (4, 8, 3, 1, 4, None, False, False),
        "repeats": (1, 8, 2, 2, 4, None, True, False),
        "kept_batch": (4, 8, 3, 1, 4, None, False, True)}.items():
    q, k, v, cot = t(B, S, H, hd), t(B, S, KV, hd), t(B, S, KV, hd), \
        t(B, S, H, hd)
    on = Shard(0) if B % 2 == 0 else Replicate()
    placed = [place(x, on, Shard(2) if x.shape[2] % 2 == 0 else Replicate())
              for x in (q, k, v)]

    def attn(q, k, v):
        heads = [1] if DL.is_dtensor(q) else None
        return chunked_attention(q, k, v, window=window, chunk=4,
                                 causal=causal, heads=heads,
                                 keep_batch=keep)
    out[name] = errs(attn, (q, k, v), placed, cot)

# the SSD scan on the heads of each rank, C·Bᵀ whole on every rank
B, S, nh, hp, N = 2, 8, 4, 4, 4
x, Bm, Cm, cot = t(B, S, nh, hp), t(B, S, N), t(B, S, N), t(B, S, nh, hp)
dt, A = t(B, S, nh).abs() * 0.5, -t(B, nh).abs()
placed = [place(x, Shard(0), Shard(2)), place(dt, Shard(0), Shard(2)),
          place(A, Shard(0), Shard(1)), place(Bm, Shard(0), Replicate()),
          place(Cm, Shard(0), Replicate())]


def scan(x, dt, A, Bm, Cm):
    return ssd_chunked(x, dt, A, Bm, Cm, 4,
                       heads=[1] if DL.is_dtensor(x) else None)


out["ssd"] = errs(scan, (x, dt, A, Bm, Cm), placed, cot)

# a product whose 5 outputs no model split divides: x's gradient over the
# whole d_in on every model rank
x, w, cot = t(4, 3, 8), t(8, 5), t(4, 3, 5)
out["unsplit"] = errs(DL.unsplit_matmul, (x, w),
                      [place(x, Shard(0), Replicate()),
                       place(w, Shard(0), Replicate())], cot)
emit(out)
"""


def test_head_split_attention_and_scan_equal_the_plain_path(tmp_path):
    """The dry run's head-split layouts on real numbers, 4 gloo ranks of a
    2×2 data × model mesh: ``chunked_attention`` (``dtensor_layouts.
    attend``: every sequence on each rank, the heads over ``model``; the
    k/v gradients on an hd slice where the query heads of a group are
    split; blocks of a batch split where the heads do not divide; ranks
    repeating a block; the batch kept split), ``ssd_chunked``
    (``by_heads``) and ``unsplit_matmul`` equal the plain path — output
    and every gradient — to 1e-5 of the output's scale, on every rank."""
    from _torch_ranks import Ranks
    for out in Ranks(_HEADS_RANKS, 4, str(tmp_path)).results():
        for name, (e, m, *grads) in out.items():
            assert e <= 1e-5 * max(1.0, m), (name, e, m)
            for i, g in enumerate(grads):
                assert g <= 1e-5 * max(1.0, m), (name, i, g, m)


_REPAIRED_RANKS = r"""
import numpy as np
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import dtensor_layouts as DL
from repro_torch.convert import params_from_numpy
from repro_torch.core.trees import tree_leaves, tree_map
from repro_torch.launch import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import kmm
from repro_torch.models.mamba2 import init_mamba, mamba_fwd
from repro_torch.models.moe import moe_apply
from test_torch_moe import _plain_case

mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
rng = np.random.default_rng(3)


def t(*shape):
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)


def placed(tree, prefix):
    specs = shd.tree_pspecs({prefix: tree}, ("data",), mesh=mesh)[prefix]
    return tree_map(lambda a, s: distribute_tensor(
        a.clone(), mesh, shd.to_placements(s, mesh)).requires_grad_(),
        tree, specs)


# fn on the DTensor arguments and on the plain ones: the largest
# difference and the plain one's scale of the output and of every
# gradient, and the output's placements
def errs(fn, plain, dist, cot):
    dist, plain = dict(enumerate(dist)), dict(enumerate(plain))
    with implicit_replication():
        o = fn(*dist.values())
        o = o[0] if isinstance(o, tuple) else o
        pls = str(o.placements)
        g = torch.autograd.grad((o * distribute_tensor(
            cot, mesh, [Replicate(), Replicate()])).sum(), tree_leaves(dist))
    plain = tree_map(lambda a: a.clone().requires_grad_(), plain)
    o0 = fn(*plain.values())
    o0 = o0[0] if isinstance(o0, tuple) else o0
    g0 = torch.autograd.grad((o0 * cot).sum(), tree_leaves(plain))
    return {"errs": [[float((a.full_tensor() - b).abs().max()),
                      float(b.abs().max())]
                     for a, b in zip([o] + list(g), [o0] + list(g0))],
            "placements": pls}


out = {}
# the decode step's router: one group of 4 tokens, the tokens split over
# both mesh dims on arrival; the logits on each rank's data shard
cfg = ModelConfig(name="t", arch_type="moe", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                  n_experts=4, top_k=2, expert_d_ff=48, n_shared_experts=1,
                  capacity_factor=1.25, dtype="float32")
params, _, _ = _plain_case()
tp = params_from_numpy(params, "cpu")
x = t(4, 1, 32)
out["router"] = errs(
    lambda p, x: moe_apply(p, x, cfg, n_groups=1), [tp, x],
    [placed(tp, "ffn"), distribute_tensor(x, mesh, [Shard(0), Shard(0)])
     .requires_grad_()], t(4, 1, 32))

# the LM head whose 5 outputs no model split divides, and a projection
# whose 4 outputs no mesh dim splits (a mamba layer's B), one token a
# data shard: the contraction over the model ranks (a partial sum there)
x, w = t(2, 1, 8), t(8, 5)
out["head"] = errs(DL.unsplit_matmul, [x, w], [
    distribute_tensor(x, mesh, [Shard(0), Replicate()]).requires_grad_(),
    distribute_tensor(w, mesh, [Shard(0), Replicate()]).requires_grad_()],
    t(2, 1, 5))
x, w = t(1, 2, 8), t(1, 8, 4)
out["proj"] = errs(kmm, [x, w], [
    distribute_tensor(x, mesh, [Shard(1), Replicate()]).requires_grad_(),
    distribute_tensor(w, mesh, [Shard(1), Replicate()]).requires_grad_()],
    t(1, 2, 4))

# two mamba layers in a row (jamba's): the first one's output projection
# reduced before the second one's projections take it
mc = ModelConfig(name="m", arch_type="ssm", n_layers=2, d_model=8,
                 n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=16,
                 ssm_state=4, ssm_head_dim=4, ssm_expand=2, ssm_chunk=4,
                 dtype="float32")
g = torch.Generator().manual_seed(0)
layers = [tree_map(lambda a: a[None], init_mamba(g, mc)) for _ in range(2)]
u = t(1, 2, 8, 8)


def two(p1, p2, u):
    h = mamba_fwd(p1, u, mc)
    return mamba_fwd(p2, u + h, mc) + h


out["mamba"] = errs(two, layers + [u], [
    placed(layers[0], "mixer"), placed(layers[1], "mixer"),
    distribute_tensor(u, mesh, [Shard(1), Replicate()]).requires_grad_()],
    t(1, 2, 8, 8))
with implicit_replication():
    pl = placed(layers[0], "mixer")
    out["mamba_out"] = str(mamba_fwd(pl, distribute_tensor(
        u, mesh, [Shard(1), Replicate()]), mc).placements)
emit(out)
"""


def test_repaired_rules_equal_the_plain_path(tmp_path):
    """The rules this dry run's repairs added, on real numbers, 4 gloo
    ranks of a 2×2 data × model mesh, against the plain path — the output
    and every gradient each to 1e-5 of its own scale, on every rank: the
    decode step's MoE router (one group, its tokens arriving split over
    both mesh dims; the logits taken on each rank's data shard), the LM
    head whose vocab no model split divides and a projection whose
    outputs no mesh dim splits, with one token a data shard
    (``unsplit_matmul``'s and ``kmm``'s contraction over the model ranks,
    a partial sum there), and two mamba layers in a row (the output
    projection reduced as ``dense`` reduces it, so the second layer's
    projections meet no partial sum)."""
    from _torch_ranks import Ranks
    for out in Ranks(_REPAIRED_RANKS, 4, str(tmp_path)).results():
        assert "Partial" in out["head"]["placements"]
        assert "Partial" in out["proj"]["placements"]
        assert "Partial" not in out["mamba_out"]
        for name in ("router", "head", "proj", "mamba"):
            for i, (e, m) in enumerate(out[name]["errs"]):
                assert e <= 1e-5 * max(1.0, m), (name, i, e, m)


# ---------------------------------------------------------------------------
# (i) the vocab-split loss and lookup
# ---------------------------------------------------------------------------
_VOCAB_RANKS = r"""
import numpy as np
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import dtensor_layouts as DL

mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
rng = np.random.default_rng(0)
B, S, V, D = 4, 3, 16, 8
lg = torch.as_tensor(rng.normal(size=(B, S, V)) * 4, dtype=torch.float32)
labels = torch.as_tensor(rng.integers(0, V, (B, S)))
table = torch.as_tensor(rng.normal(size=(V, D)), dtype=torch.float32)
cot = torch.as_tensor(rng.normal(size=(B, S, D)), dtype=torch.float32)
w = torch.as_tensor(rng.normal(size=(B, S)), dtype=torch.float32)

rows = [Shard(0), Replicate()]           # the batch over data
lgd = distribute_tensor(lg, mesh, [Shard(0), Shard(2)]).requires_grad_()
# the embedding table's layout: vocab rows over model, D over data
tabd = distribute_tensor(table, mesh, [Shard(1), Shard(0)]).requires_grad_()
with implicit_replication():
    labd = distribute_tensor(labels, mesh, rows)
    lse = DL.logsumexp(lgd)
    gold = DL.gold_logit(lgd, labd)
    g_lg, = torch.autograd.grad(
        ((lse - gold) * distribute_tensor(w, mesh, rows)).sum(), [lgd])
    emb = DL.lookup(tabd, labd)
    g_tab, = torch.autograd.grad(
        (emb * distribute_tensor(cot, mesh, rows)).sum(), [tabd])
x = lg.clone().requires_grad_()
lse0 = torch.logsumexp(x, -1)
gold0 = torch.gather(x, -1, labels[..., None])[..., 0]
g_lg0, = torch.autograd.grad(((lse0 - gold0) * w).sum(), [x])
t0 = table.clone().requires_grad_()
emb0 = t0[labels]
g_tab0, = torch.autograd.grad((emb0 * cot).sum(), [t0])


def err(a, b):
    return float((a.full_tensor().detach() - b.detach()).abs().max())


emit({"lse": err(lse, lse0), "gold": err(gold, gold0),
      "g_lg": err(g_lg, g_lg0), "emb": err(emb, emb0),
      "g_tab": err(g_tab, g_tab0), "table_local": list(
          tabd.to_local().shape),
      "g_tab_placements": str(g_tab.placements)})
"""


def test_split_logsumexp_and_lookup_equal_the_plain_ops(tmp_path):
    """On 4 gloo ranks (2×2 data × model, the vocab split over the 2 model
    ranks as the dry run splits it): ``DL.logsumexp`` and ``DL.gold_logit``
    over a vocab-split [B, S, V], and ``DL.lookup`` in a table whose rows
    are split, equal ``torch.logsumexp``, ``torch.gather`` and
    ``table[ids]`` — values and gradients, float32, to 1e-6 — on every
    rank; the table's gradient keeps the table's layout."""
    from _torch_ranks import Ranks
    for out in Ranks(_VOCAB_RANKS, 4, str(tmp_path)).results():
        assert out["table_local"] == [8, 4]
        assert out["g_tab_placements"] == "(Shard(dim=1), Shard(dim=0))"
        for what in ("lse", "gold", "g_lg", "emb", "g_tab"):
            assert out[what] <= 1e-6, (what, out[what])


@pytest.mark.parametrize("fake_group", [2], indirect=True)
def test_peak_bytes_of_a_vocab_split_logsumexp_are_the_hand_count(
        fake_group):
    """Rows of 64 logits split over 2 ranks: the peak a rank holds is
    its [8, 32] ``lg - max`` and ``exp`` temporaries and the [8, 1] max —
    no [8, 64] rows gathered whole, whose gather alone would hold as much
    as both temporaries — and the only collectives are two all-reduces of
    one value a row."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = _mesh((2,), ("model",))
    f32 = 4
    with FakeTensorMode():
        lg = distribute_tensor(torch.empty(8, 64), mesh, [Shard(1)])
        for _ in range(2):
            counter = D.StepCounter(mesh)
            counter.exclude(lg)
            with counter:
                out = DL.logsumexp(lg)
                held = counter.live_bytes
            assert counter.peak_bytes == 2 * 8 * 32 * f32 + 8 * f32
            assert held == 8 * f32 and out.to_local().shape == (8,)
            assert [op.kind for op in D.collect(counter.log)] == \
                ["all-reduce", "all-reduce"]


@pytest.mark.parametrize("fake_group", [2], indirect=True)
def test_step_counter_counts_no_bytes_where_none_move(fake_group):
    """A device query (``prim.device``), a collective's result handed on
    (``wait_tensor``, ``_wrap_tensor_autograd``), a view and a detach
    count no bytes; an elementwise op its operand and result, an
    all-gather its operand and result."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = _mesh((2,), ("data",))
    f32 = 4
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(8, 16), mesh,
                              [Shard(0)]).requires_grad_()
        t = torch.empty(4, 8)
        for _ in range(2):
            counter = D.StepCounter(mesh)
            with counter:
                torch.ops.prim.device(t)
                torch.ops._c10d_functional._wrap_tensor_autograd(t)
                t.view(8, 4)
                t.detach()
                assert counter.bytes_local == 0
                t + 1
                assert counter.bytes_local == 2 * 4 * 8 * f32
                x.redistribute(mesh, [Replicate()])
            assert counter.bytes_local == 2 * 4 * 8 * f32 + \
                (4 + 8) * 16 * f32
            assert [op.kind for op in D.collect(counter.log)] == \
                ["all-gather"]
