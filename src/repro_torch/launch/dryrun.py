"""LM-scale dry run: every (arch x input-shape x mesh) step on a fake
256- or 512-rank DTensor mesh, with rank 0's work counted — the
counterpart of the JAX package's ``launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --all \\
      --multi-pod

Each run writes ``<out>/<arch>__<shape>__<mesh>.json`` (``--out``, default
``build/dryrun/`` at the repository root).

The JAX dry run compiles each step for placeholder devices and reads
XLA's analyses of the partitioned program.  Here the process joins a fake
process group (``fake_world``: rank 0 of 256 or 512, collectives do
nothing), lays params, optimizer state, batch and cache out as DTensors of
fake tensors (shapes and dtypes, no memory) with the placements of
``launch/sharding.py``, and runs the step eagerly with ``impl="xla"`` —
no kernel.  DTensor turns each op into rank 0's local op and the
collectives its placements need; ``StepCounter``, a dispatch mode that
sees the ops below DTensor, counts them:

* ``counted_flops_per_rank``: rank 0's local matmul-class ops, forward
  and backward, by ``torch.utils.flop_counter``'s formulas;
* ``counted_batched_flops_per_rank``: the part of it in the rank's
  products of a batch of more than one matrix (attention's score and
  value products, the SSD scan's), the JAX compile's dots with batch
  dimensions on the device;
* ``counted_flops_global``: the same formulas on the DTensor ops, i.e. on
  the unsharded shapes; the local work ``dtensor_layouts.attend`` and
  ``by_heads`` run on each rank at a rank's FLOPs times the distinct
  shares the ranks run (``dtensor_layouts.local_share``);
* ``counted_bytes_per_rank``: operand plus result bytes of every local op
  that moves bytes — not a view, an alias, a device query or a
  collective's result handed on (XLA's "bytes accessed", without XLA's
  fusion);
* ``collectives``: ``hlo_analysis.summarize`` of the collectives DTensor
  issued (``collect``);
* ``argument_size_in_bytes``/``output_size_in_bytes``: rank 0's shard
  bytes of the step's arguments and outputs;
* ``counted_peak_bytes_per_rank``: the peak of the bytes held by the
  storages rank 0's local ops made, collective results included, each
  until its release (``StepCounter.peak_bytes``).

Plain tensors the step makes (RoPE tables, masks) meet the DTensors as
replicated ones (``implicit_replication``).  An op with no sharding rule
raises, and the combo's record is ``status: "error"`` with the message:
nothing falls back to plain tensors.  Importing this module sets no
environment variable and makes no process group.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_flatten
from torch.utils._pytree import tree_map as pt_map
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from .. import dtensor_layouts as DL
from ..configs import ARCHS, get_config
from ..core.trees import tree_leaves, tree_map
from ..device import resolve_device
from ..models import analysis as man
from . import hlo_analysis, sharding as shd, specs, steps
from .mesh import (axis_names, axis_sizes, fsdp_axes,
                   make_production_mesh, n_data_shards)
from .sharding import P

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")

# collectives by their JAX (HLO) names; any other keeps its own name
KIND_NAMES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}

_PROP_FILE = os.path.join("tensor", "_sharding_prop.py")


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a fake group of ``world_size`` ranks
    (a no-op when one of that size exists)."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(f"a group of {dist.get_world_size()} ranks "
                             f"exists; the dry run needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _nbytes(trees) -> int:
    """Bytes of a list of trees' tensors; a DTensor counts its local
    shard."""
    total = 0
    for x in (leaf for t in trees for leaf in tree_leaves(t)):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def _tensor_bytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(obj)[0]
               if isinstance(t, torch.Tensor))


def _in_sharding_propagation() -> bool:
    """Whether the op runs inside DTensor's sharding propagator, which
    runs ops on fake copies of the unsharded shapes to find the output's
    shape: those ops are not rank 0's work."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROP_FILE):
            return True
        f = f.f_back
    return False


def _flops(func, args, kwargs, out) -> int:
    fn = flop_registry.get(func._overloadpacket)
    return 0 if fn is None else int(fn(*args, **kwargs, out_val=out))


def _meta_like(obj):
    return pt_map(lambda t: torch.empty_strided(
        t.shape, t.stride(), dtype=t.dtype, device="meta")
        if isinstance(t, torch.Tensor) else t, obj)


# a collective's result handed on (a fake tensor gives it a storage anew)
_SAME_RESULT = {getattr(torch.ops._c10d_functional, name)
                for name in ("wait_tensor", "_wrap_tensor_autograd")
                if hasattr(torch.ops._c10d_functional, name)}

# products of a batch of matrices: with a batch > 1 on the rank,
# attention's score and value products (a projection's batch is its one
# client, an expert GEMM's the rank's one expert)
_BATCHED = {torch.ops.aten.bmm, torch.ops.aten.baddbmm}

# ops that read and write no tensor's bytes
_NOT_ACCESSED = {torch.ops.aten.detach, torch.ops.aten.alias,
                 torch.ops.aten._local_scalar_dense,
                 torch.ops.prim.device} | _SAME_RESULT


def _storages(obj) -> set:
    return {t.untyped_storage()._cdata for t in tree_flatten(obj)[0]
            if isinstance(t, torch.Tensor)}


def _moves_no_bytes(func, args, kwargs, out) -> bool:
    """Whether a local op reads and writes no bytes: a view, an op of
    ``_NOT_ACCESSED``, or an op that writes nothing and returns its
    operand's storage."""
    if func.is_view or func._overloadpacket in _NOT_ACCESSED:
        return True
    if any(r.alias_info is not None and r.alias_info.is_write
           for r in func._schema.returns):
        return False
    made = _storages(out)
    return bool(made) and made <= _storages((args, kwargs))


class StepCounter(CommDebugMode):
    """``CommDebugMode`` that also counts rank 0's local work.

    A DTensor op reaches the mode first: it counts the op's FLOPs on the
    unsharded shapes and returns ``NotImplemented``, so DTensor runs it as
    local ops and collectives, which reach the mode next.  Each collective
    is logged as (op name, result bytes, group size, mesh axis) in
    ``log``.

    ``live_bytes``/``peak_bytes``: the bytes of the storages that local ops
    made (collective results included), each from the op that made it
    until it is released — a weak reference to the storage, as
    ``MemTracker`` keeps; an op's result in a storage seen before (a view,
    an in-place update, an argument passed to ``exclude``) adds nothing."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops_local = 0
        self.flops_batched = 0
        self.flops_global = 0
        self.bytes_local = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.log = []
        self._storages = WeakIdKeyDictionary()
        self._groups = {}
        if mesh is not None:
            for name in axis_names(mesh):
                self._groups[mesh.get_group(name).group_name] = (
                    name, axis_sizes(mesh)[name])

    def exclude(self, tree) -> None:
        """Count no storage of ``tree``'s tensors (a DTensor's local
        shard): the step's arguments."""
        for t in tree_flatten(tree)[0]:
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                self._storages.setdefault(t.untyped_storage(), (0, None))

    def _made(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self._storages:
                    self._hold(st, st.nbytes())
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _moved(self, src: torch.Tensor, out: torch.Tensor) -> None:
        """``out`` is ``src`` (a collective's result handed on; a fake
        tensor gives it a storage anew): the bytes follow ``out``'s
        storage."""
        n, ref = self._storages.get(src.untyped_storage(), (0, None))
        if ref is None or out.untyped_storage() in self._storages:
            return
        self._storages[src.untyped_storage()] = (0, None)  # drops the ref
        self.live_bytes -= n
        self._hold(out.untyped_storage(), n)

    def _hold(self, st, n: int) -> None:
        self._storages[st] = (n, weakref.ref(st, functools.partial(
            self._released, n)))
        self.live_bytes += n

    def _released(self, n: int, _ref) -> None:
        self.live_bytes -= n

    def _group(self, args):
        name = next((a for a in reversed(args) if isinstance(a, str)), None)
        if name in self._groups:
            return self._groups[name]
        return name, dist.distributed_c10d._resolve_process_group(name).size()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return super().__torch_dispatch__(func, types, args, kwargs)
        if any(issubclass(t, DTensor) for t in types):
            if func._overloadpacket in flop_registry:
                margs, mkw = _meta_like((args, kwargs))
                self.flops_global += _flops(func, args, kwargs,
                                            func(*margs, **mkw))
            return super().__torch_dispatch__(func, types, args, kwargs)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if _in_sharding_propagation():
            return out
        pk = func._overloadpacket
        if pk in _SAME_RESULT:
            self._moved(args[0], out)
        else:
            self._made(out)
        flops = _flops(func, args, kwargs, out)
        self.flops_local += flops
        # a product of a batch of matrices, judged on the rank's shapes as
        # the JAX tool judges the partitioned program's dots
        if pk in _BATCHED and args[0].shape[0] > 1:
            self.flops_batched += flops
        share = DL.local_share()
        if share:       # ``attend``'s local work: no DTensor op counted it
            self.flops_global += flops * share
        if pk in self.comm_registry:
            axis, g = self._group(args)
            self.log.append((pk.__name__, _tensor_bytes(out), g, axis))
        if not _moves_no_bytes(func, args, kwargs, out):
            self.bytes_local += _tensor_bytes((args, kwargs, out))
        return out


def collect(log):
    """``hlo_analysis.CollectiveOp``s of a ``StepCounter``'s log: the JAX
    kind names (another collective keeps its own), operand bytes by the
    module's convention from the result bytes R and group size g
    (all-gather R/g, reduce-scatter R·g, else R), the mesh axis as the
    computation, multiplier 1 — the port loops over the blocks in Python,
    so every layer's collectives are in the log."""
    ops = []
    for name, rb, g, axis in log:
        kind = KIND_NAMES.get(name, name)
        if kind == "all-gather":
            ob = rb // max(g, 1)
        elif kind == "reduce-scatter":
            ob = rb * g
        else:
            ob = rb
        ops.append(hlo_analysis.CollectiveOp(kind, str(axis), rb, g, ob, 1))
    return ops


# ---------------------------------------------------------------------------
# layout: meta trees + spec trees -> DTensors of fake tensors
# ---------------------------------------------------------------------------
def _local_shape(shape, spec, sizes) -> tuple:
    out = list(shape)
    for d, ax in enumerate(spec):
        if ax is not None:
            out[d] //= shd._axis_prod(sizes, ax)
    return tuple(out)


def layout(meta_tree, spec_tree, mesh, fake_mode, device):
    """DTensors of fake tensors on ``device``: each leaf of ``meta_tree``
    laid out by its spec (rank 0's shard of the global shape)."""
    sizes = axis_sizes(mesh)

    def one(meta, spec):
        with fake_mode:
            local = torch.empty(_local_shape(meta.shape, spec, sizes),
                                dtype=meta.dtype, device=device)
        return DTensor.from_local(local, mesh, shd.to_placements(spec, mesh),
                                  run_check=False, shape=meta.shape,
                                  stride=meta.stride())
    return tree_map(one, meta_tree, spec_tree)


def _strip_axis(pspecs, axis: str):
    def strip(spec):
        return P(*[
            (None if ax == axis else
             (tuple(a for a in ax if a != axis) or None)
             if isinstance(ax, tuple) else ax)
            for ax in spec])
    return tree_map(strip, pspecs)


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                attn_chunk: int = 1024, overrides: dict = None,
                cfg_override=None, mesh=None, device="cuda"):
    """Returns (step, args, info): the step function and its DTensor
    arguments on ``mesh`` (default: the production mesh of the fake
    world), or (None, None, {"skipped": True, ...}).  ``shape_name``: a
    key of ``specs.INPUT_SHAPES`` or an ``InputShape``.

    ``overrides`` — the hill-climb levers:
      attn_chunk:int, loss_chunk:int, remat:bool,
      residual:"seq_model" (sequence-parallel residual stream),
      tp_off:bool (replicate params over the model axis)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg_override or get_config(arch)
    shape = (specs.INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    ok, why = specs.supports(cfg, shape)
    if not ok:
        return None, None, {"skipped": True, "reason": why}

    dev = resolve_device(device)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    fsdp = fsdp_axes(mesh)
    n_groups = n_data_shards(mesh)
    overrides = overrides or {}
    attn_chunk = overrides.get("attn_chunk", attn_chunk)
    # the residual stream: batch over the data axes, the layout XLA's
    # propagation reaches from the batch's sharding (DTensor picks each
    # op's layout alone, and would carry the embedding's D-sharding into
    # every projection); the seq_model lever adds sequence over model
    da = specs.batch_axes(mesh)
    stream = P(None, da if shape.global_batch > 1 else None,
               "model" if overrides.get("residual") == "seq_model" else None,
               None)                                     # [K, B, S, D]
    bk = {"residual_spec": shd.to_placements(stream, mesh)}
    if overrides.get("loss_chunk"):
        bk["loss_chunk"] = int(overrides["loss_chunk"])
    if overrides.get("remat"):
        bk["remat"] = True

    pshape = steps.params_shape(cfg)
    pspecs = shd.tree_pspecs(pshape, fsdp, mesh=mesh)
    if overrides.get("tp_off"):
        pspecs = _strip_axis(pspecs, "model")
    info = dict(man.model_flops(cfg, pshape, shape))
    sizes = axis_sizes(mesh)
    info.update(arch=arch, shape=shape.name,
                mesh="x".join(str(sizes[a]) for a in axis_names(mesh)),
                n_devices=int(math.prod(sizes.values())),
                device=dev.type)

    fm = FakeTensorMode(allow_non_fake_inputs=True)
    params = layout(pshape, pspecs, mesh, fm, dev)
    bshape = specs.batch_specs(cfg, shape)
    batch = layout(bshape, specs.batch_pspecs(cfg, shape, mesh), mesh, fm,
                   dev)
    if shape.kind == "train":
        # the full config's choice, also at a cut depth (as the train runs)
        n_full = (info["n_params"] if cfg_override is None else
                  steps.param_count(steps.params_shape(get_config(arch))))
        optimizer, opt_name = steps.make_optimizer(cfg, n_full)
        info["optimizer"] = opt_name
        with torch.device("meta"):
            oshape = optimizer.init(pshape)
        ospecs = shd.sanitize_tree(
            shd.opt_state_pspecs(oshape, pshape, fsdp), oshape, mesh)
        if overrides.get("tp_off"):
            ospecs = _strip_axis(ospecs, "model")
        fn = steps.make_train_step(cfg, optimizer, n_groups=n_groups,
                                   attn_chunk=attn_chunk, impl="xla", **bk)
        args = (params, layout(oshape, ospecs, mesh, fm, dev), batch)
    elif shape.kind == "prefill":
        fn = steps.make_prefill_step(cfg, n_groups=n_groups,
                                     attn_chunk=attn_chunk, **bk)
        args = (params, batch)
    else:  # decode
        cshape = specs.cache_specs(cfg, shape)
        cache = layout(cshape, specs.cache_pspecs(cshape, cfg, shape, mesh),
                       mesh, fm, dev)
        fn = steps.make_serve_step(cfg)
        args = (params, cache, batch["token"], batch["index"])
    info["argument_size_in_bytes"] = _nbytes(list(args))
    return fn, args, info


def analyse(fn, args, info) -> dict:
    """Run the step once under a ``StepCounter`` and return the record."""
    from torch.distributed.tensor.experimental import implicit_replication
    out = dict(info)
    counter = StepCounter(tree_leaves(args[0])[0].device_mesh)
    counter.exclude(args)
    t0 = time.perf_counter()
    with implicit_replication(), counter:
        result = fn(*args)
    out["step_s"] = round(time.perf_counter() - t0, 3)
    out["output_size_in_bytes"] = _nbytes(
        list(result) if isinstance(result, tuple) else [result])
    out["counted_flops_per_rank"] = counter.flops_local
    out["counted_batched_flops_per_rank"] = counter.flops_batched
    out["counted_flops_global"] = counter.flops_global
    out["counted_bytes_per_rank"] = counter.bytes_local
    out["counted_peak_bytes_per_rank"] = counter.peak_bytes
    out["collectives"] = hlo_analysis.summarize(collect(counter.log))
    return out


def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def cut_depth(cfg, blocks: int):
    """``cfg`` with ``blocks`` super-blocks (an encoder-decoder: that many
    layers each side), the widths unchanged."""
    kw = dict(n_layers=len(cfg.block_pattern()) * blocks)
    if cfg.encoder_layers:
        kw["encoder_layers"] = blocks
    return dataclasses.replace(cfg, **kw)


def record_tag(arch: str, shape_name: str, mesh_tag: str,
               overrides: dict = None, blocks: int = None) -> str:
    """The name of a combo's record, ``<out>/<tag>.json``."""
    tag = f"{arch}__{shape_name}__{mesh_tag}"
    if overrides:
        tag += "__" + "_".join(f"{k}{v}" for k, v in sorted(overrides.items()))
    if blocks:
        tag += f"__blocks{blocks}"
    return tag


def read_record(out_dir: str, tag: str):
    """The record ``<out_dir>/<tag>.json``, or None."""
    path = os.path.join(out_dir, tag + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def start_combo(arch: str, mesh_tag: str, out_dir: str, *,
                shape_name: str = None, blocks: int = None,
                overrides: dict = None, device: str = "cuda"):
    """Start ``python -m repro_torch.launch.dryrun --force`` on ``arch``
    (every shape, or ``shape_name``) on one mesh in a process of its own —
    the fake group stays in the process that joins it — its output to
    ``<out_dir>/<tag>.log`` (``record_tag``, shape ``all`` for every
    shape).  Returns (the process, the log's path)."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
           device, "--arch", arch, "--force", "--out", out_dir]
    if shape_name:
        cmd += ["--shape", shape_name]
    if mesh_tag == _mesh_tag(True):
        cmd.append("--multi-pod")
    if blocks:
        cmd += ["--blocks", str(blocks)]
    for k, v in sorted((overrides or {}).items()):
        cmd += ["--override", f"{k}={v}"]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    log = os.path.join(out_dir, record_tag(arch, shape_name or "all",
                                           mesh_tag, overrides, blocks)
                       + ".log")
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=src),
                                stdout=f, stderr=subprocess.STDOUT)
    return proc, log


def run_one(arch: str, shape_name: str, multi_pod: bool, force: bool = False,
            overrides: dict = None, out_dir: str = RESULTS_DIR,
            device="cuda", blocks: int = None) -> dict:
    """One combo's record, written to ``out_dir`` (read back from there
    unless ``force``).  ``blocks`` cuts the depth (``cut_depth``)."""
    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = _mesh_tag(multi_pod)
    tag = record_tag(arch, shape_name, mesh_tag, overrides, blocks)
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        cfg = cut_depth(get_config(arch), blocks) if blocks else None
        fn, args, info = lower_combo(arch, shape_name, multi_pod=multi_pod,
                                     overrides=overrides, cfg_override=cfg,
                                     device=device)
        if info.get("skipped"):
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                   "status": "skipped", "reason": info["reason"]}
        else:
            rec = analyse(fn, args, info)
            rec["status"] = "ok"
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {tag}: {rec['status']} "
          f"(step={rec.get('step_s', '-')}s)", flush=True)
    return rec


def depth_counts(cfg, shape_name: str, *, mesh=None, multi_pod=False,
                 device="cuda") -> dict:
    """The JAX package's depth calibration on the same dims at 1 and 2
    super-blocks: ``c1``, ``c2`` and ``corrected = c1 + (N-1)(c2-c1)``
    of the counted FLOPs and bytes, N the config's super-blocks (layers
    for an encoder-decoder).  Eager counting sees every layer, so the
    corrected counts equal the full-depth ones."""
    vals = {}
    for n in (1, 2):
        fn, args, info = lower_combo(cfg.name, shape_name,
                                     multi_pod=multi_pod, mesh=mesh,
                                     cfg_override=cut_depth(cfg, n),
                                     device=device)
        rec = analyse(fn, args, info)
        vals[n] = {"flops": rec["counted_flops_per_rank"],
                   "bytes": rec["counted_bytes_per_rank"]}
    N = cfg.n_blocks if cfg.arch_type != "audio" else cfg.n_layers
    corrected = {k: vals[1][k] + (N - 1) * (vals[2][k] - vals[1][k])
                 for k in ("flops", "bytes")}
    return {"c1": vals[1], "c2": vals[2], "n_units": N,
            "corrected": corrected}


def calibrate(arch: str, shape_name: str, multi_pod: bool = False,
              out_dir: str = RESULTS_DIR, device="cuda") -> dict:
    """Patch ``counted_*_per_rank_corrected`` and ``calib`` into the
    combo's record (``depth_counts``)."""
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{_mesh_tag(multi_pod)}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok" or "calib" in rec:
        return rec
    try:
        cal = depth_counts(get_config(arch), shape_name,
                           multi_pod=multi_pod, device=device)
        rec["counted_flops_per_rank_corrected"] = cal["corrected"]["flops"]
        rec["counted_bytes_per_rank_corrected"] = cal["corrected"]["bytes"]
        rec["calib"] = {k: cal[k] for k in ("c1", "c2", "n_units")}
    except Exception as e:
        rec["calib_error"] = f"{type(e).__name__}: {e}"
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    full = rec.get("counted_flops_per_rank", 0)
    print(f"[calib] {arch}__{shape_name}__{_mesh_tag(multi_pod)}: "
          f"corrected/full flops "
          f"{rec.get('counted_flops_per_rank_corrected', 0) / max(full, 1):.6f}",
          flush=True)
    return rec


def parse_overrides(pairs) -> dict:
    """``--override k=v`` arguments as the levers' dict (ints, booleans,
    else strings)."""
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        out[k] = (int(v) if v.isdigit() else
                  v == "true" if v in ("true", "false") else v)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="k=v hillclimb override (attn_chunk/loss_chunk/"
                         "remat/residual/tp_off)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory of the JSON records")
    ap.add_argument("--blocks", type=int, default=None,
                    help="super-blocks to keep (default: the config's)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    overrides = parse_overrides(args.override)

    fake_world(512 if args.multi_pod else 256)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(specs.INPUT_SHAPES)
    recs = []
    for a in archs:
        for s in shapes:
            if args.calibrate:
                recs.append(calibrate(a, s, args.multi_pod, args.out,
                                      args.device))
            else:
                recs.append(run_one(a, s, args.multi_pod, args.force,
                                    overrides=overrides or None,
                                    out_dir=args.out, device=args.device,
                                    blocks=args.blocks))
    return recs


if __name__ == "__main__":
    main()
