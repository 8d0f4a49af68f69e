"""Parameter / batch / cache sharding rules, and the SPMD helpers of the
sweeps — the counterpart of the JAX package's ``launch/sharding.py``.

Tensor-parallel ("model" axis): attention heads, d_ff, MoE experts, mamba
d_inner/heads, vocab of embed/lm_head.
FSDP ("data" axis, + "pod" on the multi-pod mesh): the other large axis of
every big matrix, so params/grads/optimizer state scale down with the full
data-parallel world (ZeRO-3 style).

Rules are matched on the '/'-joined tree path; specs apply to the TRAILING
dims of the leaf, so stacked block params ([n_blocks, ...]) get a leading
None automatically.  A spec is a ``P``: one entry a tensor dim, each a mesh
axis name, a tuple of names, or None (replicated); ``to_placements`` turns
it into DTensor placements on a ``DeviceMesh``.

JAX's ``shard_map`` has no torch counterpart: the port's sweeps are SPMD,
one process a rank, and every rank runs its block of a leading axis
(``leading_block``) and reassembles the whole through ``gather_leading``.
"""
from __future__ import annotations

import math
import re
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.trees import _is_namedtuple, tree_map
from .mesh import axis_names, axis_sizes

FS = "__FSDP__"          # placeholder replaced by the mesh's fsdp axes


class P(tuple):
    """A partition spec: ``P("data", None)`` is the tuple ``("data",
    None)``; specs compare with ``==`` as tuples do."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else \
            f"P({self[0]!r})"


_RULES: Sequence[Tuple[str, tuple]] = (
    # MoE experts [E, D, F] / [E, F, D]: experts over model, D over fsdp
    (r"ffn/(wg|wu)$",        ("model", FS, None)),
    (r"ffn/wd$",             ("model", None, FS)),
    (r"router$",             (None, None)),
    # shared expert + dense MLP [D, F] / [F, D]
    (r"(shared|ffn|mlp)/(wg|wu)/w$", (FS, "model")),
    (r"(shared|ffn|mlp)/wd/w$",      ("model", FS)),
    # attention
    (r"(wq|wk|wv)/w$",       (FS, "model")),
    (r"(wq|wk|wv)/b$",       ("model",)),
    (r"wo/w$",               ("model", FS)),
    (r"wo/b$",               (None,)),
    # mamba2
    (r"(wz|wx|wdt)$",        (FS, "model")),
    (r"(wB|wC)$",            (FS, None)),
    (r"conv_x$",             (None, "model")),
    (r"conv_bx$",            ("model",)),
    (r"(conv_B|conv_C)$",    (None, None)),
    (r"mixer/norm$",         ("model",)),
    (r"out_proj$",           ("model", FS)),
    # decision-fusion heads (small)
    (r"(vision|audio_head)/(proj|w1)$", (None, None)),
    (r"(vision|audio_head)/w2$",        (None, "model")),
    # embeddings
    (r"lm_head$",            (FS, "model")),
    (r"embed$",              ("model", FS)),
)


def _resolve(spec: tuple, fsdp: Optional[tuple]) -> tuple:
    # a singleton fsdp axis collapses to its bare name: P("data") and
    # P(("data",)) shard identically but do not compare equal as specs
    if fsdp is not None and len(fsdp) == 1:
        fsdp = fsdp[0]
    return tuple((fsdp if s == FS else s) for s in spec)


def param_pspec(path: str, ndim: int, fsdp: Optional[tuple]) -> P:
    for pat, spec in _RULES:
        if re.search(pat, path):
            spec = _resolve(spec, fsdp)
            spec = spec[:ndim]
            pad = ndim - len(spec)
            return P(*((None,) * pad + tuple(spec)))
    return P(*((None,) * ndim))        # replicate (norms, scalars, biases)


def _path_str(path) -> str:
    """'/'-joined path of a leaf (``_map_with_path``'s tuple of parts)."""
    return "/".join(path)


def _map_with_path(fn, tree, *rest, path=()):
    """``tree_map`` whose ``fn`` also gets the leaf's path: a tuple of dict
    keys and, for NamedTuple fields, ``#.field`` (the JAX package's
    rendering of a field in its key paths)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], *(r[k] for r in rest),
                                  path=path + (k,))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(
            _map_with_path(fn, *xs, path=path + (f"#.{f}",))
            for f, *xs in zip(tree._fields, tree, *rest)))
    return fn(path, tree, *rest)


def _axis_prod(sizes: dict, ax) -> int:
    names = ax if isinstance(ax, tuple) else (ax,)
    return int(math.prod(sizes[n] for n in names))


def sanitize_pspec(spec: P, shape, mesh) -> P:
    """Drop sharding on any dim whose size is not divisible by the mesh
    axes (e.g. GQA kv=8 heads cannot shard over model=16, whisper's 51865
    vocab cannot shard over 16).  Dropped dims are recorded replicated.
    ``mesh``: a ``DeviceMesh``, or any object with a ``.shape`` dict."""
    sizes = axis_sizes(mesh)
    dims = []
    for d in range(len(shape)):
        ax = spec[d] if d < len(spec) else None
        if ax is None:
            dims.append(None)
            continue
        dims.append(ax if shape[d] % _axis_prod(sizes, ax) == 0 else None)
    return P(*dims)


def sanitize_tree(pspecs, tree, mesh):
    return tree_map(lambda s, leaf: sanitize_pspec(s, tuple(leaf.shape),
                                                   mesh),
                    pspecs, tree)


def tree_pspecs(tree, fsdp: Optional[tuple], mesh=None):
    """``P`` tree matching ``tree`` (tensors of any device, meta ones
    included)."""
    out = _map_with_path(
        lambda path, leaf: param_pspec(_path_str(path), leaf.ndim, fsdp),
        tree)
    if mesh is not None:
        out = sanitize_tree(out, tree, mesh)
    return out


def to_placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(d)`` where tensor dim ``d`` is split over that mesh axis (alone
    or in a tuple of axes), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dim = next((d for d, ax in enumerate(spec)
                    if ax == name or (isinstance(ax, tuple) and name in ax)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def tree_shardings(tree, mesh, fsdp: Optional[tuple]):
    return tree_map(lambda s: to_placements(s, mesh),
                    tree_pspecs(tree, fsdp))


def serving_buffer_shardings(bufs, mesh):
    """Placements of the flat serving param buffers (launch/parambuf).

    Decode reads the whole parameter set every step, and the flat layout
    erases the per-tensor axes the ``_RULES`` table keys on — so the
    buffers are REPLICATED across the mesh: every rank holds a full copy,
    a round-boundary hot swap is one in-place copy on every rank, and the
    decode path has no collective."""
    return tree_map(lambda _: to_placements(P(), mesh), bufs)


# ---------------------------------------------------------------------------
# population sweeps: logical axis rules for the 2-D ("scenario", "clients")
# mesh — callers name the LOGICAL axes of each tensor and the rules table
# maps them to mesh axes; a rule absent from the mesh degrades to
# replication.
# ---------------------------------------------------------------------------
SWEEP_AXIS_RULES: Sequence[Tuple[str, Optional[str]]] = (
    ("scenario", "scenario"),   # grid rows — independent whole experiments
    ("clients", "clients"),     # population axis of the client store / xs
    ("rounds", None),           # the round axis — never sharded
    ("batch", None),            # per-client samples — never sharded
)


def logical_pspec(axes: Sequence[Optional[str]], mesh=None,
                  rules=SWEEP_AXIS_RULES) -> P:
    """``P`` for a tensor whose dims carry the given logical axis names
    (None = unnamed/replicated dim).  Names missing from the rules table,
    mapped to None, or mapped to an axis the ``mesh`` doesn't carry all
    resolve to replication."""
    table = dict(rules)
    names = None if mesh is None else axis_names(mesh)
    dims = []
    for ax in axes:
        mesh_ax = table.get(ax) if ax is not None else None
        if names is not None and mesh_ax is not None and \
                mesh_ax not in names:
            mesh_ax = None
        dims.append(mesh_ax)
    return P(*dims)


def pad_leading_axis(tree, multiple: int):
    """Pad every leaf's leading axis to a multiple of ``multiple`` by
    repeating the last row (duplicate work, dropped by
    ``slice_leading_axis`` — never garbage values, so padded rows still
    run the real program)."""
    def pad(x):
        n = (-x.shape[0]) % multiple
        if n == 0:
            return x
        return torch.cat([x, x[-1:].expand((n,) + tuple(x.shape[1:]))])
    return tree_map(pad, tree)


def slice_leading_axis(tree, n: int):
    """Drop the rows ``pad_leading_axis`` added."""
    return tree_map(lambda x: x[:n], tree)


# ---------------------------------------------------------------------------
# SPMD: a rank's block of a leading axis, and the whole axis back
# ---------------------------------------------------------------------------
def leading_block(n: int, n_blocks: int, index: int) -> slice:
    """Rows of block ``index`` when ``n`` rows (a multiple of
    ``n_blocks``) split into ``n_blocks`` equal blocks."""
    if n % n_blocks:
        raise ValueError(f"{n} rows do not split into {n_blocks} blocks")
    b = n // n_blocks
    return slice(index * b, (index + 1) * b)


def gather_leading(tree, group):
    """Every leaf's blocks from all ranks of ``group``, concatenated along
    the leading axis in group-rank order (a tiled all-gather); every rank
    passes a block of one shape.

    The one collective primitive of the port's sweeps is an ``all_reduce``
    of a buffer filled with the sum's identity into which each rank writes
    its own block: gloo handles only ``broadcast`` and ``all_reduce`` for
    CUDA tensors, so the same code runs on gloo (the CPU tests, several
    ranks on one card) and on NCCL.  Floats are filled with ``-0.0``, the
    exact identity of IEEE addition (``-0.0 + x == x`` bit for bit, a
    ``-0.0`` block included, where a ``+0.0`` fill would turn it into
    ``+0.0``), integers with 0; bool leaves travel as int32.  Each output
    element receives one block's value plus identities, so the result is
    exact."""
    n, i = dist.get_world_size(group), dist.get_rank(group)

    def one(x):
        rows = x.shape[0]
        out = _identity((n * rows,) + tuple(x.shape[1:]), x)
        out[i * rows:(i + 1) * rows] = x
        return _all_sum(out, group, x.dtype)
    return tree_map(one, tree)


def _identity(shape, like):
    dt = torch.int32 if like.dtype == torch.bool else like.dtype
    fill = -0.0 if dt.is_floating_point else 0
    return torch.full(shape, fill, dtype=dt, device=like.device)


def _all_sum(buf, group, dtype):
    dist.all_reduce(buf, group=group)
    return buf.to(torch.bool) if dtype == torch.bool else buf


def masked_sum(x, mine, group):
    """``x`` where ``mine`` (leading-axis mask) holds, the sum's identity
    elsewhere, summed over ``group``: each row's value from the one rank
    that owns it (``gather_leading``'s primitive)."""
    buf = _identity(tuple(x.shape), x)
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    src = x.to(buf.dtype) if x.dtype == torch.bool else x
    buf = torch.where(mine.reshape(shape), src, buf)
    return _all_sum(buf, group, x.dtype)


# ---------------------------------------------------------------------------
# optimizer state: same layout as the matching parameter
# ---------------------------------------------------------------------------
def opt_state_pspecs(opt_state_shape, params_shape, fsdp: Optional[tuple]):
    """Optimizer-state specs built structurally from the parameter specs:
    adam m/v mirror the parameter layout; adafactor row stats drop the last
    param dim, col stats the second-last; scalars replicate."""
    pspecs = tree_pspecs(params_shape, fsdp)

    def factored(spec, leaf):
        s = tuple(spec)
        if leaf.ndim >= 2:
            return {"r": P(*s[:-1]), "c": P(*(s[:-2] + (s[-1],)))}
        return {"v": P(*s)}

    out = {}
    for key, sub in opt_state_shape.items():
        if key == "step":
            out[key] = P()
        elif key in ("m", "v"):
            out[key] = pspecs
        elif key == "f":
            out[key] = tree_map(factored, pspecs, params_shape)
        else:
            out[key] = tree_map(lambda _: P(), sub)
    return out
