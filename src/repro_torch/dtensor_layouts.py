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


def _contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


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


def _moved_split(t: torch.Tensor, mesh_dims, dim: Optional[int],
                 n: Optional[int] = None) -> list:
    """``t``'s placements with each mesh dim of ``mesh_dims`` splitting
    ``dim`` where the split of ``dim`` so far times its size still divides
    ``n`` (default: ``dim``'s size), else replicating (``dim`` None: all
    replicate)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, pls = t.device_mesh, list(t.placements)
    if dim is not None:
        dim %= t.dim()
        n = t.shape[dim] if n is None else n
    have = math.prod(mesh.size(i) for i, pl in enumerate(pls)
                     if i not in mesh_dims and dim is not None
                     and pl.is_shard(dim))
    for i in mesh_dims:
        if dim is not None and n % (have * mesh.size(i)) == 0:
            have *= mesh.size(i)
            pls[i] = Shard(dim)
        else:
            pls[i] = Replicate()
    return pls


def split_heads(t: torch.Tensor, n: int, dim: int = -1,
                batch: Optional[int] = None) -> torch.Tensor:
    """``t`` ready to view its ``dim`` as [n, ...]: a DTensor whose
    ``dim`` is split over more ranks than divide ``n`` is replicated over
    them first (KV heads fewer than the model axis: every rank holds them
    all, as Megatron replicates KV heads), or, given a ``batch`` dim that
    the split still divides, split along ``batch`` instead (query heads
    that do not divide the model axis, as llama4-scout's 40: the ranks
    take other sequences rather than all repeat the same attention);
    anything else as it is."""
    if not is_dtensor(t):
        return t
    mesh, dim = t.device_mesh, dim % t.dim()
    split = [i for i, pl in enumerate(t.placements) if pl.is_shard(dim)]
    if n % math.prod(mesh.size(i) for i in split) == 0:
        return t
    return t.redistribute(mesh, _moved_split(t, split, batch))


def batch_split(t: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """A DTensor split along dim 0 only: each mesh dim that splits ``t``
    splits dim 0 where the split so far times its size still divides
    ``n`` (default: dim 0's size), else replicates.  DTensor views split
    or merge a dim only where no later dim of the group is sharded, so the
    chunked contractions (attention, the SSD scan, the MoE groups) take
    operands split along the batch only.  Anything else as it is."""
    if not is_dtensor(t):
        return t
    pls = _moved_split(t, [i for i, pl in enumerate(t.placements)
                           if pl.is_shard()], 0, n)
    if tuple(pls) == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, pls)


def split_groups(t: torch.Tensor) -> torch.Tensor:
    """Attention's operand [B, G, ...] (G the KV-head groups) for the
    chunked contraction, whose batch dims are its first two.  A DTensor
    split along dim 0 only (``batch_split``) is viewed as [B·G, 1, ...]
    and the merged dim split over each mesh dim, in the mesh's order,
    where the split so far times its size still divides B·G: a mesh dim
    that the batch cannot take (8 sequences a data shard on a 16-rank
    model axis) splits the groups of a sequence, as XLA splits the heads
    over it, rather than every rank of it repeating the same attention.
    Anything else as it is."""
    if not is_dtensor(t):
        return t
    t = t.reshape(t.shape[0] * t.shape[1], 1, *t.shape[2:])
    pls = _moved_split(t, range(t.device_mesh.ndim), 0)
    if tuple(pls) == tuple(t.placements):
        return t
    # the operand (a permuted view) and its returning gradient made
    # contiguous: DTensor gives the redistributed tensor and its gradient
    # the global strides of a permuted layout while the rank's tensor
    # comes out of the collective contiguous, and the view of the
    # gradient back to the projection's [.., H·hd] fails on it
    t = t.contiguous()
    return _ContiguousGrad.apply(t.redistribute(t.device_mesh, pls))


def join_groups(t: torch.Tensor, batch: int) -> torch.Tensor:
    """``split_groups`` undone: a DTensor [B·G, 1, ...] brought to a split
    the batch ``B`` alone takes (``batch_split``) and viewed as
    [B, G, ...]; anything else as it is."""
    if not is_dtensor(t):
        return t
    t = batch_split(t, batch)
    return t.reshape(batch, t.shape[0] // batch, *t.shape[2:])


def fsdp_gather(w: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
    """A DTensor weight ``w`` gathered over each mesh dim that splits one
    of ``by``'s dims other than its last (the tokens ``w`` meets; the last
    is the contraction), its other placements kept: FSDP's gather of a
    weight before its use, so each rank's GEMMs take its own rows whole
    and no gradient comes back as a partial sum the backward would meet
    with the weight gathered whole anyway.  Anything else as it is."""
    if not is_dtensor(w) or not is_dtensor(by):
        return w
    from torch.distributed.tensor import Replicate
    last = by.dim() - 1
    pls = [Replicate() if b.is_shard() and b.dim != last else pl
           for pl, b in zip(w.placements, by.placements)]
    return constrain(w, pls)


def matmul_operands(x: torch.Tensor, w: torch.Tensor):
    """(x, w) laid out for ``x @ w`` (w [..., d_in, d_out]) if both are
    DTensors: ``w`` gathered as ``fsdp_gather`` gathers it; ``x``'s last
    dim split over each mesh dim that splits ``w``'s ``d_in`` and
    replicates ``x``, so the rank keeps only its slice of ``x`` for the
    backward and computes the weight gradient of its own rows; and
    ``w``'s ``d_out`` split over each mesh dim that replicates both, where
    the split so far times its size divides it, so a small weight left
    whole on every rank is not applied to the same tokens on all of them.
    Each is a slice of what the rank holds, no collective.  Anything else
    as it is."""
    if not is_dtensor(x) or not is_dtensor(w):
        return x, w
    from torch.distributed.tensor import Shard
    w = fsdp_gather(w, x)
    x = constrain(x, [Shard(x.dim() - 1) if px.is_replicate()
                      and pw.is_shard(w.dim() - 2) else px
                      for px, pw in zip(x.placements, w.placements)])
    both = [i for i, (px, pw) in enumerate(zip(x.placements, w.placements))
            if px.is_replicate() and pw.is_replicate()]
    if both:
        w = constrain(w, _moved_split(w, both, -1))
    return x, w


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (an embedding lookup).  On DTensors whose table rows
    (the vocab) are split over ranks, each rank looks its ids up in its
    own rows: the table is gathered over every other mesh dim (FSDP's
    gather of the columns, and the rows over a mesh dim that also splits
    the ids), the ids are shifted by the rank's first row and clamped into
    its rows, and the rows of ids outside them are zeroed — the shapes are
    static, so fake tensors run it.  The result is a partial sum over the
    mesh dims that split the rows, reduced as ``reduce_partial`` reduces
    it, and laid out as ``ids`` are elsewhere; the table's gradient lands
    on each rank's own rows.  A table whose rows are not split (its
    columns only, or nothing) is gathered whole, as FSDP gathers a weight
    before its use, and each rank looks up its own ids (DTensor's own
    index rule does not take ids split over two mesh dims)."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    rows = [i for i, (pl, by) in enumerate(zip(table.placements,
                                               ids.placements))
            if pl.is_shard(0) and not by.is_shard()]
    pls = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    grad = [Shard(0) if i in rows else Partial() if by.is_shard()
            else Replicate() for i, by in enumerate(ids.placements)]
    local = table.redistribute(mesh, pls).to_local(grad_placements=grad)
    n = local.shape[0]
    j = ids.to_local() - _shard_index(mesh, rows) * n
    out = local[j.clamp(0, n - 1)]
    if rows:
        out = torch.where(((j >= 0) & (j < n))[..., None], out,
                          out.new_zeros(()))
    shape = (*ids.shape, table.shape[-1])
    placed = [Partial() if i in rows else pl
              for i, pl in enumerate(ids.placements)]
    return reduce_partial(DTensor.from_local(
        out, mesh, placed, run_check=False, shape=shape,
        stride=_contiguous_stride(shape)))


def _shard_index(mesh, dims) -> int:
    """This rank's shard of a tensor dim split over the mesh dims
    ``dims`` (in the mesh's order, the first the coarsest)."""
    coord, k = mesh.get_coordinate(), 0
    for i in dims:
        k = k * mesh.size(i) + coord[i]
    return k


def _label_mask(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``arange(V) == labels[..., None]`` for lg [..., V], a DTensor laid
    out as ``lg``: each rank compares its own vocab positions with its own
    rows' labels and makes its block of the mask, so no rank holds a
    whole [..., V] row of it and no torch release's broadcast rule picks
    another layout."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh, last = lg.device_mesh, lg.dim() - 1
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    rows = constrain(labels, [Replicate() if pl.is_shard(last) else pl
                              for pl in lg.placements])
    dims = [i for i, pl in enumerate(lg.placements) if pl.is_shard(last)]
    n = lg.to_local().shape[-1]
    first = _shard_index(mesh, dims) * n
    hit = torch.arange(first, first + n, device=lg.device) == \
        rows.to_local()[..., None].long()
    return DTensor.from_local(hit, mesh, lg.placements, run_check=False,
                              shape=lg.shape,
                              stride=_contiguous_stride(lg.shape))


def gold_logit(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``lg[..., labels]``: each label's logit (lg [..., V], labels [...]
    ints).  On a DTensor it is the masked sum over the vocab dim, the same
    value, the mask laid out as ``lg`` is (``_label_mask``): a gather
    along a dim split over ranks builds a data-dependent mask, which fake
    tensors cannot.  The sum is reduced and pinned, so its
    gradient comes back split as its rows are before it meets the vocab
    dim (a gradient replicated over a mesh dim that splits the rows would
    be expanded to whole [..., V] rows first)."""
    idx = labels[..., None].long()
    if not is_dtensor(lg):
        return torch.gather(lg, -1, idx)[..., 0]
    lg = reduce_partial(lg)
    hit = _label_mask(lg, labels)
    return pin(reduce_partial(torch.where(hit, lg, lg.new_zeros(())).sum(-1)))


def logsumexp(lg: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(lg, -1)``.  On a DTensor whose last dim is split
    over ranks it is the log-sum-exp of the split dim: each rank's max
    reduced as a max and its sum of ``exp(lg - max)`` reduced as a sum
    across the ranks that split the dim (one value a row each), the log
    taken after; no rank holds the [..., V] row whole.  The max is a
    constant to autograd, so the gradient is the softmax, as
    ``torch.logsumexp``'s."""
    if not is_dtensor(lg) or not any(pl.is_shard(lg.dim() - 1)
                                     for pl in lg.placements):
        return torch.logsumexp(lg, dim=-1)
    lg = reduce_partial(lg)
    top = reduce_partial(lg.detach().amax(-1, keepdim=True))
    total = reduce_partial(torch.exp(lg - top).sum(-1))
    return torch.log(total) + top[..., 0]


def reduce_partial(t: torch.Tensor, dim: Optional[int] = None
                   ) -> torch.Tensor:
    """A DTensor with each partial mesh dim reduced: scattered along
    ``dim`` where ``dim``'s split so far times the mesh dim's size divides
    it (a reduce-scatter), else all-reduced (over that mesh dim alone;
    DTensor's own plan for a later op may gather a dim another mesh dim
    splits first); anything else as it is."""
    if not is_dtensor(t):
        return t
    partial = [i for i, pl in enumerate(t.placements) if pl.is_partial()]
    if not partial:
        return t
    return t.redistribute(t.device_mesh, _moved_split(t, partial, dim))


def argmax(lg: torch.Tensor) -> torch.Tensor:
    """``lg.argmax(-1)``.  On a DTensor it is the first index that holds
    the maximum, from a max and a min over the last dim, each reduced
    across the ranks that split it: DTensor's own argmax gathers every
    rank's winner, a view that fails on a [1, 1, V] split over ranks."""
    if not is_dtensor(lg):
        return lg.argmax(-1)
    lg = reduce_partial(lg)
    n = lg.shape[-1]
    top = reduce_partial(lg.amax(-1, keepdim=True))
    pos = torch.arange(n, device=lg.device)
    return reduce_partial(torch.where(lg == top, pos, n).amin(-1))


def softmax(s: torch.Tensor) -> torch.Tensor:
    """``torch.softmax(s, -1)``.  On a DTensor whose last dim is split
    over ranks it is the softmax of the split dim: each rank's max and sum
    of exponentials reduced across the ranks (two all-reduces of one value
    a row), never the scores gathered whole."""
    if not is_dtensor(s) or not any(pl.is_shard(s.dim() - 1)
                                    for pl in s.placements):
        return torch.softmax(s, dim=-1)
    s = reduce_partial(s)
    e = torch.exp(s - reduce_partial(s.amax(-1, keepdim=True)))
    return e / reduce_partial(e.sum(-1, keepdim=True))


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


def by_group(fn, *args):
    """``fn(*args)``, ``fn`` mapping tensors whose dim 0 counts groups to
    a tuple of such tensors.  On DTensors each rank runs ``fn`` on its own
    groups, as JAX's ``vmap`` over groups split over the data axes runs:
    every DTensor argument is laid out as the first one's dim 0 is split
    (dim 0 over those mesh dims, replicated over the others), ``fn`` runs
    on the local tensors, and its results come back as DTensors laid out
    the same, their gradients too.  The MoE capacity dispatch's index ops
    (top-k, sorts, scatters and gathers by index) have no sharding rule in
    every torch release, and need none there: a group lies whole on the
    ranks that hold it."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    first = next(a for a in args if is_dtensor(a))
    mesh = first.device_mesh
    pls = [Shard(0) if pl.is_shard(0) else Replicate()
           for pl in first.placements]
    split = math.prod(mesh.size(i) for i, pl in enumerate(pls)
                      if pl.is_shard())
    out = fn(*(a.redistribute(mesh, pls).to_local(grad_placements=pls)
               if is_dtensor(a) else a for a in args))

    def wrap(o):
        shape = (o.shape[0] * split, *o.shape[1:])
        return DTensor.from_local(o, mesh, pls, run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape))
    return tuple(map(wrap, out))


def scaled_rsqrt(v: torch.Tensor, eps: float, g: torch.Tensor
                 ) -> torch.Tensor:
    """``g · rsqrt(v + eps)``, in ``v``'s buffer (Adafactor's update); a
    DTensor ``v`` may be a partial sum, which no in-place op keeps, so it
    is computed out of place."""
    if is_dtensor(v):
        return torch.rsqrt(v + eps) * g
    return v.add_(eps).rsqrt_().mul_(g)
