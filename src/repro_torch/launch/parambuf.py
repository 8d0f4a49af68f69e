"""Flat parameter buffers: a params tree packed into one contiguous 1-D
buffer per dtype, with a static layout (``ParamSpec``).

The layout is the JAX package's (``repro/launch/parambuf.py``) to the
element: leaves in ``jax.tree_util`` flatten order (sorted dict keys at
every level, list entries in order), ``'/'``-joined key paths (list entries
``#i``), per-dtype element offsets in that order, dtype names such as
``"float32"`` and ``"bfloat16"``, and the buffers keyed by sorted dtype
name.  So ``pack_np`` buffers are byte-equal across the two packages and a
flat checkpoint of either restores in the other.

``unpack`` returns views of the buffers (slices and ``view``, no copy): a
decode step reading params through them touches the buffers themselves,
so a CUDA graph captured on those views reads whatever the buffers hold.
``make_swap`` is the hot swap: each new leaf is ``copy_``'d into its slot
of the old allocation — no new allocation, the buffers' ``data_ptr()``
stay — and a leaf that already *is* its slot's view is skipped, so a
serving tree whose frozen LM was unpacked from the buffers rewrites only
the leaves that changed.  ``pack_np``/``unpack_np`` are the host mirror,
which ``checkpoint.save_flat_checkpoint`` writes.  bfloat16 on the host is
numpy's two-byte void (``convert.py``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..convert import BF16_VOID, as_tensor, is_bf16, tensor_to_numpy


class LeafSpec(NamedTuple):
    path: str                    # '/'-joined key path (checkpoint convention)
    shape: Tuple[int, ...]
    dtype: str                   # canonical dtype name, e.g. "float32"
    offset: int                  # element offset into this dtype's buffer


class ParamSpec(NamedTuple):
    """Static (hashable) layout of a packed tree."""
    treedef: Any                             # nested containers, see _structure
    leaves: Tuple[LeafSpec, ...]             # in flatten order
    sizes: Tuple[Tuple[str, int], ...]       # (dtype name, total elements)

    @property
    def n_buffers(self) -> int:
        return len(self.sizes)

    def nbytes(self) -> int:
        return sum(n * _itemsize(dt) for dt, n in self.sizes)


def _itemsize(name: str) -> int:
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def dtype_name(leaf) -> str:
    """The JAX package's dtype name of a tensor or numpy leaf."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    a = np.asarray(leaf)
    return "bfloat16" if is_bf16(a) else a.dtype.name


def _np_dtype(name: str) -> np.dtype:
    return BF16_VOID if name == "bfloat16" else np.dtype(name)


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _flatten(tree, prefix: str = ""):
    """(path, leaf) pairs in flatten order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [pl for k, v in items
            for pl in _flatten(v, f"{prefix}/{k}" if prefix else k)]


def _structure(tree):
    """A hashable skeleton of the containers (``None`` for a leaf)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return None


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(td):
        if td is None:
            return next(it)
        kind, kids = td
        if kind == "dict":
            return {k: build(sub) for k, sub in kids}
        seq = [build(sub) for sub in kids]
        return tuple(seq) if kind == "tuple" else seq
    return build(treedef)


def _leaf_size(shape: Tuple[int, ...]) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def spec_of(tree) -> ParamSpec:
    """Freeze ``tree``'s layout.  Works on tensors (meta tensors too) and
    numpy arrays."""
    offsets: Dict[str, int] = {}
    leaves = []
    for path, leaf in _flatten(tree):
        dt = dtype_name(leaf)
        shape = tuple(leaf.shape)
        off = offsets.get(dt, 0)
        leaves.append(LeafSpec(path, shape, dt, off))
        offsets[dt] = off + _leaf_size(shape)
    return ParamSpec(_structure(tree), tuple(leaves),
                     tuple(sorted(offsets.items())))


def _tree_leaves(tree):
    return [leaf for _, leaf in _flatten(tree)]


def pack(tree, spec: ParamSpec = None) -> Dict[str, torch.Tensor]:
    """tree -> {dtype name: 1-D buffer} on the leaves' device, leaves in
    flatten order."""
    if spec is None:
        spec = spec_of(tree)
    groups: Dict[str, list] = {}
    for ls, leaf in zip(spec.leaves, _tree_leaves(tree)):
        groups.setdefault(ls.dtype, []).append(
            as_tensor(leaf).detach().to(_torch_dtype(ls.dtype))
            .reshape(-1))
    return {dt: torch.cat(groups[dt]) for dt, _ in spec.sizes}


def unpack(bufs: Dict[str, torch.Tensor], spec: ParamSpec):
    """{dtype: buffer} -> the original tree, every leaf a view of its
    buffer (no copy)."""
    leaves = [bufs[ls.dtype][ls.offset:ls.offset + _leaf_size(ls.shape)]
              .view(ls.shape) for ls in spec.leaves]
    return _unflatten(spec.treedef, leaves)


def pack_np(tree, spec: ParamSpec = None):
    """Host-side pack into numpy buffers (the checkpoint flat layout).
    Returns ``(bufs, spec)`` with the element layout of ``pack``; a
    bfloat16 buffer is two-byte void."""
    if spec is None:
        spec = spec_of(tree)
    bufs = {dt: np.empty(n, dtype=_np_dtype(dt)) for dt, n in spec.sizes}
    for ls, leaf in zip(spec.leaves, _tree_leaves(tree)):
        n = _leaf_size(ls.shape)
        a = (tensor_to_numpy(leaf) if isinstance(leaf, torch.Tensor)
             else np.asarray(leaf))
        if ls.dtype == "bfloat16":
            a = np.ascontiguousarray(a).view(BF16_VOID)
        else:
            a = a.astype(_np_dtype(ls.dtype), copy=False)
        bufs[ls.dtype][ls.offset:ls.offset + n] = a.reshape(-1)
    return bufs, spec


def unpack_np(bufs: Dict[str, np.ndarray], spec: ParamSpec):
    """Host-side inverse of ``pack_np`` (views of the buffers)."""
    leaves = [bufs[ls.dtype][ls.offset:ls.offset + _leaf_size(ls.shape)]
              .reshape(ls.shape) for ls in spec.leaves]
    return _unflatten(spec.treedef, leaves)


def make_swap(spec: ParamSpec):
    """``swap(bufs, new_tree) -> bufs``: each leaf of ``new_tree`` is
    ``copy_``'d into its slot of the old buffers, in place — the buffers
    keep their allocation and ``data_ptr()``.  A leaf that already is its
    slot's view (same address, dtype and size) is skipped.
    ``swap.bytes_written`` holds the bytes the last call wrote."""
    @torch.no_grad()
    def swap(bufs, tree):
        written = 0
        for ls, leaf in zip(spec.leaves, _tree_leaves(tree)):
            seg = bufs[ls.dtype][ls.offset:ls.offset + _leaf_size(ls.shape)]
            leaf = as_tensor(leaf)
            if (leaf.device == seg.device and leaf.dtype == seg.dtype
                    and leaf.numel() == seg.numel()
                    and leaf.data_ptr() == seg.data_ptr()):
                continue
            seg.copy_(leaf.reshape(-1))
            written += seg.numel() * seg.element_size()
        swap.bytes_written = written
        return bufs
    swap.bytes_written = 0
    return swap
