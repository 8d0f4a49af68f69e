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

import contextlib
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


def split_heads(t: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """``t`` ready to view its ``dim`` as [n, ...]: a DTensor whose
    ``dim`` is split over more ranks than divide ``n`` is replicated over
    them first (KV heads fewer than the model axis: every rank holds them
    all, as Megatron replicates KV heads); anything else as it is."""
    if not is_dtensor(t):
        return t
    mesh, dim = t.device_mesh, dim % t.dim()
    split = [i for i, pl in enumerate(t.placements) if pl.is_shard(dim)]
    if n % math.prod(mesh.size(i) for i in split) == 0:
        return t
    return t.redistribute(mesh, _moved_split(t, split, None))


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


# the local work ``attend`` and ``by_heads`` run on each rank: how many
# distinct shares of
# it the ranks run together (``share``: a rank's FLOPs times it are the
# unsharded op's), and the slice of the hd dim on which ``head_product``
# takes its second operand's gradient (``slices``: count, this rank's
# slice, whether this rank's copy of it counts)
_LOCAL = [None]


def local_share() -> Optional[int]:
    """How many distinct shares of the local work running now the ranks
    run together, or None outside ``attend``'s and ``by_heads``' local
    work (the dry run's counter multiplies a local op's FLOPs by it for
    the unsharded count)."""
    return _LOCAL[0]["share"] if _LOCAL[0] else None


@contextlib.contextmanager
def _local(region):
    old, _LOCAL[0] = _LOCAL[0], region
    try:
        yield
    finally:
        _LOCAL[0] = old


class _LocalRun(torch.autograd.Function):
    """``fn`` on a rank's local tensors inside a ``_local`` region, its
    backward too: the forward keeps the graph it builds (nothing is
    recomputed) and the backward runs it in the same region."""

    @staticmethod
    def forward(ctx, fn, region, *ins):
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in ins]
        with torch.enable_grad(), _local(region):
            out = fn(*leaves)
        ctx.region, ctx.leaves, ctx.out = region, leaves, out
        return out.detach().contiguous()

    @staticmethod
    def backward(ctx, g):
        want = [t for t in ctx.leaves if t.requires_grad]
        with _local(ctx.region):
            got = iter(torch.autograd.grad(ctx.out, want, g))
        ctx.out = None
        # contiguous, as the forward's result: the DTensor a local tensor
        # returns to takes its strides as the global ones, and one in the
        # permuted layout of the heads' products would then fail the view
        # to (or back to) the projection's [.., H·hd]
        return (None, None, *(next(got).contiguous() if t.requires_grad
                              else None for t in ctx.leaves))


class _Product(torch.autograd.Function):
    """``torch.einsum(eq, a, b)`` inside the local work, each product
    counted at its own share: the forward and ``a``'s gradient at
    ``share``, ``b``'s gradient taken on one of ``n`` slices of ``b``'s
    last dim (``part``; zeros elsewhere, and nothing where this rank's
    copy of the slice does not count, ``keep``) at ``share · n``.  ``eq``
    has two operands and no index that only one of the three tensors
    carries."""

    @staticmethod
    def forward(ctx, eq, a, b, n, part, keep, share):
        ctx.save_for_backward(a, b)
        ctx.eq, ctx.slice, ctx.share = eq, (n, part, keep), share
        with _local(dict(_LOCAL[0], share=share)):
            return torch.einsum(eq, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        (ia, ib), io = ctx.eq.split("->")[0].split(","), ctx.eq.split("->")[1]
        n, part, keep = ctx.slice
        da = db = None
        if ctx.needs_input_grad[1]:
            with _local(dict(_LOCAL[0], share=ctx.share)):
                da = torch.einsum(f"{io},{ib}->{ia}", g, b)
        if ctx.needs_input_grad[2]:
            h, size = ib[-1], b.shape[-1] // n
            sa = a.narrow(ia.index(h), part * size, size) if h in ia else a
            sg = g.narrow(io.index(h), part * size, size) if h in io else g
            with _local(dict(_LOCAL[0], share=ctx.share * n)):
                got = torch.einsum(f"{ia},{io}->{ib}", sa, sg)
            if n == 1:
                db = got
            else:
                db = b.new_zeros(b.shape)
                if keep:
                    db.narrow(-1, part * size, size).copy_(got)
        return None, da, db, None, None, None, None


def head_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)``: attention's score or value product, b
    the keys or values [.., hd].  Inside ``attend``'s local work on a rank
    whose layout splits the k/v gradients (``slices``), b's gradient comes
    on this rank's hd slice only (``_Product``), as XLA partitions them;
    anything else the plain einsum."""
    region = _LOCAL[0]
    if region is None or region["slices"] is None:
        return torch.einsum(eq, a, b)
    return _Product.apply(eq, a, b, *region["slices"], region["share"])


def shared_product(eq: str, a: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of operands without the heads' dim (the
    SSD scan's C·Bᵀ): inside ``by_heads``' local work every rank computes
    it whole, as XLA's does, and it counts once for the unsharded op
    (``_Product`` at share 1); anything else the plain einsum."""
    if _LOCAL[0] is None:
        return torch.einsum(eq, a, b)
    return _Product.apply(eq, a, b, 1, 0, True, 1)


def by_heads(fn, parts, *, out_dim: int, heads):
    """``fn(*tensors)`` of ``parts`` ((tensor, its heads' dim or None),
    dim 0 the batch), a tensor whose ``out_dim`` is the heads': the SSD
    scan.  On DTensors each rank runs ``fn`` on its own heads, laid out as
    the JAX package's compile lays the scan out: every sequence of the
    batch on each rank (gathered over the mesh dims that do not split the
    heads), the heads split over ``heads`` (the mesh dims that split the
    projection weights' output features, ``feature_dims``) where they
    divide, the tensors without a heads' dim whole on every rank.  The
    result returns to the first tensor's layout; the gradients of the
    tensors without heads come back as partial sums.  Anything else:
    ``fn(*tensors)``."""
    ts = [t for t, _ in parts]
    if not any(is_dtensor(t) for t in ts):
        return fn(*ts)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    first = ts[0]
    mesh = first.device_mesh
    M = math.prod(mesh.size(i) for i in heads)
    if any(d is not None and t.shape[d] % M for t, d in parts):
        heads, M = [], 1
    local = []
    for t, d in parts:
        if not is_dtensor(t):
            local.append(t)
            continue
        pls = [Replicate()] * mesh.ndim
        gpls = list(pls)
        for i in heads:
            pls[i] = Replicate() if d is None else Shard(d % t.dim())
            gpls[i] = Partial() if d is None else pls[i]
        local.append(t.redistribute(mesh, pls).to_local(grad_placements=gpls))
    o = _LocalRun.apply(fn, {"share": M, "slices": None}, *local)
    pls = [Replicate()] * mesh.ndim
    for i in heads:
        pls[i] = Shard(out_dim)
    shape = list(o.shape)
    shape[out_dim] *= M
    out = DTensor.from_local(o, mesh, pls, run_check=False,
                             shape=tuple(shape),
                             stride=_contiguous_stride(shape))
    return out.redistribute(mesh, first.placements)


def attend(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           heads, keep_batch: bool = False) -> torch.Tensor:
    """``fn(q, k, v)``, attention: q [B, Sq, H, hd], k/v [B, Sk, KV, hd]
    (KV dividing H) to o [B, Sq, H, hd], laid out as q.

    On DTensors each rank runs ``fn`` on its own block, laid out as the
    JAX package's compile lays attention out.  The heads split over the
    mesh dims ``heads`` (those that split the projection weights' output
    features, ``feature_dims``), M ranks:
    the KV-head groups over gcd(KV, M) of them, then the query heads of a
    group over gcd(H/KV, the rest), then the batch over what is left where
    it divides (a head count no split divides, as llama4-scout's 40 over
    16, or fewer heads than ranks).  Every other mesh dim holds every
    sequence of the batch (gathered), as XLA's token stream does, or with
    ``keep_batch`` keeps the split q's batch arrives with, as XLA keeps
    the split of an input's embeddings (an encoder over them, and a
    cross-attention over its output).  Where the query heads of a group
    are split r > 1 ways and the gathered dims hold a multiple of r ranks,
    the k and v gradients (``head_product``) are taken on an hd slice,
    1/r of hd a rank, the slice chosen by the rank's place on the gathered
    dims, as XLA splits them.  The result returns to q's layout; the
    gradients come back as partial sums over the ranks that share a
    tensor.  Anything else: ``fn(q, k, v)``."""
    if not any(is_dtensor(t) for t in (q, k, v)):
        return fn(q, k, v)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    R = H // KV
    hdims = list(heads)
    bdims = [i for i in range(mesh.ndim) if i not in hdims]
    if keep_batch:       # the batch keeps the split of q's batch dims
        bdims = [i for i in bdims if q.placements[i].is_shard(0)]
    M = math.prod(mesh.size(i) for i in hdims)
    across = math.prod(mesh.size(i) for i in bdims)
    # ranks splitting the batch, and ranks holding the same batch
    split, copies = (across, 1) if keep_batch else (1, across)
    batch = B // split
    g = math.gcd(KV, M)
    r = math.gcd(R, M // g)
    b = math.gcd(batch, M // (g * r))
    rest = M // (g * r * b)              # ranks repeating one block
    gi, ri, bi = _block_index(_shard_index(mesh, hdims), (g, r, b, rest))
    aligned = b * rest == 1 and H % M == 0 and (KV == g or r == 1)
    kv_split = KV % M == 0
    c = _shard_index(mesh, bdims)
    n = r if r > 1 and copies % r == 0 and hd % r == 0 else 1
    on_batch = Shard(0) if keep_batch else Replicate()

    def local(t, split, grad):
        pls = [Replicate()] * mesh.ndim
        for i in bdims:
            pls[i] = on_batch
        for i in hdims:
            pls[i] = Shard(2) if split else Replicate()
        gpls = list(pls)
        for i in hdims:
            gpls[i] = Shard(2) if split else Partial()
        for i in bdims:
            gpls[i] = grad
        return t.redistribute(mesh, pls).to_local(grad_placements=gpls)

    ql = local(q, aligned, on_batch)
    kl, vl = (local(t, kv_split, Partial() if n > 1 else on_batch)
              for t in (k, v))
    if not aligned:
        ql = ql.reshape(batch, Sq, KV, R, hd)
        ql = ql.narrow(2, gi * (KV // g), KV // g).narrow(
            3, ri * (R // r), R // r).reshape(batch, Sq, -1, hd)
        if not kv_split:
            kl, vl = (t.narrow(2, gi * (KV // g), KV // g) for t in (kl, vl))
        ql, kl, vl = (t.narrow(0, bi * (batch // b), batch // b)
                      for t in (ql, kl, vl))
    elif not kv_split:
        first = _shard_index(mesh, hdims) * (H // M) // R
        kl, vl = (t.narrow(2, first, max(H // M // R, 1))
                  for t in (kl, vl))
    region = {"share": g * r * b * split,
              "slices": (n, c % n, c < n) if n > 1 else None}
    o = _LocalRun.apply(fn, region, ql, kl, vl)
    pls = [Replicate()] * mesh.ndim
    for i in bdims:
        pls[i] = on_batch
    if aligned:
        for i in hdims:
            pls[i] = Shard(2)
        out = DTensor.from_local(o, mesh, pls, run_check=False,
                                 shape=q.shape,
                                 stride=_contiguous_stride(q.shape))
        return out.redistribute(mesh, q.placements)
    # every rank's block gathered over the head dims and put in place
    on = [Shard(1) if pl.is_shard() else pl for pl in pls]
    for i in hdims:
        on[i] = Shard(0)
    shape = (M, o.shape[0] * split, *o.shape[1:])
    blocks = DTensor.from_local(o[None], mesh, on, run_check=False,
                                shape=shape, stride=_contiguous_stride(shape))
    blocks = blocks.redistribute(mesh, [Replicate() if i in hdims else pl
                                        for i, pl in enumerate(on)])
    blocks = blocks.to_local().reshape(g, r, b, rest, batch // b, Sq,
                                       KV // g, R // r, hd)[:, :, :, 0]
    mine = blocks.permute(2, 3, 4, 0, 5, 1, 6, 7).reshape(
        batch, Sq, H, hd).contiguous()
    out = DTensor.from_local(mine, mesh, pls, run_check=False,
                             shape=q.shape,
                             stride=_contiguous_stride(q.shape))
    return out.redistribute(mesh, q.placements)


def _block_index(m: int, sizes) -> tuple:
    """The (KV-group block, query-head block, batch block) of the rank
    ``m``-th along the head-splitting mesh dims, ``sizes`` the counts of
    each and of the ranks repeating a block (row-major)."""
    g, r, b, rest = sizes
    return m // (r * b * rest), m // (b * rest) % r, m // rest % b

def feature_dims(w: torch.Tensor, dim: int = -1):
    """The mesh dims that split a DTensor weight's last dim (a
    projection's output features: tensor parallelism's dims), or its
    ``dim``; None for anything else."""
    if not is_dtensor(w):
        return None
    dim %= w.dim()
    return [i for i, pl in enumerate(w.placements) if pl.is_shard(dim)]


def replicate(t: torch.Tensor, dims) -> torch.Tensor:
    """A DTensor gathered over the mesh dims ``dims`` (replicated there),
    its other placements kept; anything else (or ``dims`` None) as it
    is."""
    if dims is None or not is_dtensor(t):
        return t
    return constrain(t, _moved_split(t, dims, None))


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
    DTensors: ``w`` gathered as ``fsdp_gather`` gathers it, and ``x``'s
    last dim split over each mesh dim that splits ``w``'s ``d_in`` and
    replicates ``x``, so the rank keeps only its slice of ``x`` for the
    backward and computes the weight gradient of its own rows (a slice
    of what the rank holds, no collective).  A small weight left whole on
    every rank is applied to the same tokens on all of them, as XLA's
    partitioning applies mamba2-370m's in train_4k and prefill_32k —
    unless XLA moves the tokens to the weight instead (``_moves_tokens``:
    a few tokens a data shard): then ``d_in`` is split over the mesh dims that
    split neither operand, ``w`` unsplit elsewhere along it, and the
    product is a partial sum over those dims.  Anything else as it is."""
    if not is_dtensor(x) or not is_dtensor(w):
        return x, w
    from torch.distributed.tensor import Replicate, Shard
    din = w.dim() - 2
    free = _moves_tokens(x, w)
    if free:
        return (constrain(x, [Shard(x.dim() - 1) if i in free else pl
                              for i, pl in enumerate(x.placements)]),
                constrain(w, [Shard(din) if i in free else Replicate()
                              if pl.is_shard(din) else pl
                              for i, pl in enumerate(w.placements)]))
    w = fsdp_gather(w, x)
    x = constrain(x, [Shard(x.dim() - 1) if px.is_replicate()
                      and pw.is_shard(din) else px
                      for px, pw in zip(x.placements, w.placements)])
    return x, w


def _moves_tokens(x: torch.Tensor, w: torch.Tensor) -> list:
    """The mesh dims that split neither operand of ``x @ w`` if XLA's
    partitioning splits the contraction over them instead of repeating
    the product there, else []: a few tokens a data shard on 16×16 (the
    decode step's 8, the prefill's last positions) — whisper-base's LM
    head ``[8, 32] · [32, 51865]`` a device, mamba2-370m's B and C
    projections ``[8, 64] · [64, 128]`` (the tokens of a data shard,
    d_model over the 16 model ranks; the weight's shard permuted there,
    not gathered) — against ``[4, 512] · [512, 51865]`` on 2×16×16 and
    whole rows over every position in train_4k and prefill_32k.  No
    single rule of XLA's cost model gives all of these,
    so this is keyed on what the compiles show: the mesh dims that split
    w's d_in (its FSDP split) all split x's rows, they hold as many ranks
    as the free dims (the weight's shard moves from one to the other
    whole), and a rank holds at most d_out rows (its block of x is no
    larger than the whole w, which the other way gathers: jamba's
    ``[8, 256] · [256, 16]`` moves, whisper-base's prefill head, 65536
    rows a rank, does not)."""
    mesh, din, last = w.device_mesh, w.dim() - 2, x.dim() - 1
    free = [i for i, (px, pw) in enumerate(zip(x.placements, w.placements))
            if px.is_replicate() and pw.is_replicate()]
    fsdp = [i for i, pl in enumerate(w.placements) if pl.is_shard(din)]
    size = math.prod(mesh.size(i) for i in fsdp)
    if not free or not fsdp or size != math.prod(mesh.size(i) for i in free):
        return []
    if x.shape[-1] % size or not all(
            x.placements[i].is_shard() and x.placements[i].dim != last
            for i in fsdp):
        return []
    rows = math.prod(x.shape[:-1]) // math.prod(
        mesh.size(i) for i, pl in enumerate(x.placements) if pl.is_shard())
    return free if rows <= w.shape[-1] else []


class _WholeInputGrad(torch.autograd.Function):
    """``x @ w`` (``matmul_operands``' layouts) whose backward takes x's
    gradient over the whole d_in on every rank of the mesh dims ``keep``
    leaves whole: the output's gradient split along dim 0 over the mesh
    dims that split w's d_in, whole over the rest, against the whole
    weight.  w's gradient is the plain product's."""

    @staticmethod
    def forward(ctx, x, w):
        xl, wl = (t.detach().requires_grad_(t.requires_grad) for t in (x, w))
        with torch.enable_grad():
            y = torch.matmul(*matmul_operands(xl, wl))
        ctx.graph, ctx.pls = (y, wl), x.placements
        ctx.save_for_backward(w)
        return y.detach()

    @staticmethod
    def backward(ctx, g):
        (w,), (y, wl) = ctx.saved_tensors, ctx.graph
        dw = None
        if ctx.needs_input_grad[1]:
            dw, = torch.autograd.grad(y, [wl], g, retain_graph=True)
        ctx.graph = None
        from torch.distributed.tensor import Replicate
        mesh = w.device_mesh
        rows = [i for i, pl in enumerate(w.placements)
                if pl.is_shard(w.dim() - 2)]
        pls = _moved_split(g, rows, 0)
        for i in range(mesh.ndim):
            if i not in rows:
                pls[i] = Replicate()
        whole = w.redistribute(mesh, [Replicate()] * mesh.ndim)
        dx = torch.matmul(g.redistribute(mesh, pls),
                          whole.transpose(-1, -2).to(g.dtype))
        return dx.redistribute(mesh, ctx.pls), dw


def unsplit_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (w [d_in, d_out]).  On DTensors whose weight no mesh dim
    splits along d_out (no model split divides it, so the JAX package's
    ``sanitize_pspec`` leaves it whole: whisper-base's 51865 and
    mamba2-370m's 50280-word vocab) while some mesh dim splits neither of
    its dims, the product runs as XLA partitions it: ``matmul_operands``'
    layouts, so no model rank takes an uneven slice of d_out, the forward
    and w's gradient split as x's rows are; x's gradient runs over the
    whole d_in, the output's gradient split over the mesh dims that split
    w's d_in only, on every rank of the others
    (``_WholeInputGrad``).  x's rows are split further over the mesh
    dims that split neither of w's dims, where its dim 0 divides (as
    ``dense`` scatters a partial sum); where it does not, those ranks
    repeat the product, as XLA's do — unless XLA moves the tokens to the
    weight instead (``_moves_tokens``): then the contraction is split
    over those ranks (``matmul_operands``) and the result is a partial
    sum over them.  Anything else: ``x @ w``."""
    if not is_dtensor(x) or not is_dtensor(w):
        return x @ w
    last = w.dim() - 1
    if any(pl.is_shard(last) for pl in w.placements) or all(
            pl.is_shard(last - 1) for pl in w.placements):
        return x @ w
    dims = [i for i, (px, pw) in enumerate(zip(x.placements, w.placements))
            if px.is_shard(0) or pw.is_replicate()]
    x = constrain(x, _moved_split(x, dims, 0))
    if _moves_tokens(x, w):
        return torch.matmul(*matmul_operands(x, w))
    return _WholeInputGrad.apply(x, w)


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
