"""How the LM-scale dry run (``launch/dryrun.py``) lays out DTensors.

The dry run runs the model, loss and optimizer code on DTensors of fake
tensors.  DTensor lays each op out alone, and not every torch release has
a sharding rule for every op the plain code uses, so that code calls the
functions below at the few points where a DTensor needs a layout or
another form of the same op.  On a plain tensor each function is the
plain op, or returns its argument: the training, serving and MFL paths
run the code they ran before.  This module imports nothing of the
package, so any layer can call it, and it does not import
``torch.distributed.tensor``: a DTensor exists only once its maker has
imported that, so the plain paths never load it.
"""
from __future__ import annotations

import math
import sys
from typing import Optional

import torch
import torch.nn.functional as F


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def constrain(x: torch.Tensor, placements) -> torch.Tensor:
    """``x`` redistributed to ``placements`` (one ``Placement`` a mesh dim)
    if it is a DTensor; anything else as it is, as JAX's
    ``with_sharding_constraint`` changes no number."""
    if placements is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements)


def pin(t: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed to its own placements: a no-op forward
    whose backward brings the gradient back to them (the next op's
    backward may split it another way, which a view before this one could
    not take); anything else as it is."""
    return t.redistribute(t.device_mesh, t.placements) if is_dtensor(t) \
        else t


def split_heads(t: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """``t`` ready to view its ``dim`` as [n, ...]: a DTensor whose
    ``dim`` is split over more ranks than divide ``n`` is replicated over
    them first (KV heads fewer than the model axis: every rank holds them
    all, as Megatron replicates KV heads); anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    mesh, dim = t.device_mesh, dim % t.dim()
    split = [i for i, pl in enumerate(t.placements) if pl.is_shard(dim)]
    if n % math.prod(mesh.size(i) for i in split) == 0:
        return t
    return t.redistribute(mesh, [Replicate() if i in split else pl
                                 for i, pl in enumerate(t.placements)])


def batch_split(t: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """A DTensor split along dim 0 only: each mesh dim that splits ``t``
    splits dim 0 where the split so far times its size still divides
    ``n`` (default: dim 0's size), else replicates.  DTensor views split
    or merge a dim only where no later dim of the group is sharded, so the
    chunked contractions (attention, the SSD scan, the MoE groups) take
    operands split along the batch only.  Anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    n = t.shape[0] if n is None else n
    mesh, pls = t.device_mesh, list(t.placements)
    split = 1
    for i, pl in enumerate(pls):
        if not pl.is_shard():
            continue
        if n % (split * mesh.size(i)) == 0:
            split *= mesh.size(i)
            pls[i] = Shard(0)
        else:
            pls[i] = Replicate()
    if tuple(pls) == tuple(t.placements):
        return t
    return t.redistribute(mesh, pls)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (an embedding lookup).  On DTensors the table is
    gathered whole, as FSDP gathers a weight before its use, and each rank
    looks up its own ids: the result is laid out as ``ids`` are, and the
    table's gradient is the ranks' partial sums.  (A lookup into rows
    split over ranks needs a data-dependent mask, which fake tensors
    cannot compute, and DTensor's own index rule does not take ids split
    over two mesh dims.)"""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial()] * mesh.ndim)
    out = whole[ids.to_local()]
    shape = (*ids.shape, table.shape[-1])
    return DTensor.from_local(out, mesh, ids.placements, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def gold_logit(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``lg[..., labels]``: each label's logit (lg [..., V], labels [...]
    ints).  On a DTensor it is the masked sum over the vocab dim, the same
    value: a gather along a dim split over ranks builds a data-dependent
    mask, which fake tensors cannot."""
    idx = labels[..., None].long()
    if not is_dtensor(lg):
        return torch.gather(lg, -1, idx)[..., 0]
    hit = torch.arange(lg.shape[-1], device=lg.device) == idx
    return torch.where(hit, lg, lg.new_zeros(())).sum(-1)


def pad_left(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``n`` zeros before ``t`` along ``dim`` (``F.pad``; a DTensor is
    concatenated with zeros, the same values)."""
    if not is_dtensor(t):
        pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [n, 0]
        return F.pad(t, pad)
    shape = list(t.shape)
    shape[dim] = n
    return torch.cat([t.new_zeros(shape), t], dim=dim)


def prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)``; on a DTensor the same sums as a product
    with a triangle of ones, since not every torch release has a DTensor
    rule for cumsum's backward (``flip``)."""
    if not is_dtensor(x):
        return torch.cumsum(x, dim=dim)
    dim = dim % x.dim()
    n = x.shape[dim]
    upper = torch.ones((n, n), dtype=x.dtype, device=x.device).triu()
    src = "abcdefgh"[:x.dim()]
    out = src[:dim] + "z" + src[dim + 1:]
    return torch.einsum(f"{src},{src[dim]}z->{out}", x, upper)


def write_slot(buf: torch.Tensor, slot: torch.Tensor,
               new: torch.Tensor) -> None:
    """``buf[:, slot] = new`` in place (``index_copy_`` along dim 1; a
    DTensor, for which not every release has an ``index_copy_`` rule, is
    rewritten through a select over the whole buffer)."""
    if not is_dtensor(buf):
        buf.index_copy_(1, slot, new.to(buf.dtype))
        return
    pos = torch.arange(buf.shape[1], device=buf.device)
    hit = (pos == slot).reshape(1, -1, *([1] * (buf.dim() - 2)))
    buf.copy_(torch.where(hit, new.to(buf.dtype), buf))


def whole(fn, *args):
    """``fn(*args)``.  DTensor arguments are gathered whole on every rank
    first and ``fn`` runs on their local tensors, its tensor results
    coming back as replicated DTensors: the MoE capacity dispatch's index
    ops (top-k, sorts, scatters and gathers by index) have no sharding
    rule in every torch release, so each rank routes the whole group."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    rep = [Replicate()] * mesh.ndim
    out = fn(*(a.redistribute(mesh, rep).to_local() if is_dtensor(a) else a
               for a in args))
    wrap = (lambda o: DTensor.from_local(o, mesh, rep, run_check=False)
            if isinstance(o, torch.Tensor) else o)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def scaled_rsqrt(v: torch.Tensor, eps: float, g: torch.Tensor
                 ) -> torch.Tensor:
    """``g · rsqrt(v + eps)``, in ``v``'s buffer (Adafactor's update); a
    DTensor ``v`` may be a partial sum, which no in-place op keeps, so it
    is computed out of place."""
    if is_dtensor(v):
        return torch.rsqrt(v + eps) * g
    return v.add_(eps).rsqrt_().mul_(g)
