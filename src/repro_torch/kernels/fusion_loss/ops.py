"""Differentiable wrappers around the fusion-loss kernels.

The kernels take a whole cohort: per-modality operands [K, T, V] (or a
compact broadcast head [K, B, V] with ``seg[m] = S``, T = B·S), labels
[K, T] and availability [M, K, T].

* ``fusion_loss_fwd`` / ``fusion_loss_bwd`` run one kernel direction each —
  the CUDA kernel for CUDA tensors, the plain version (``ref.py``) for CPU
  tensors, and nothing else: a CUDA tensor the kernel cannot take raises.
  Operands go in as they are, float32, bfloat16 or float16 (the kernel
  converts in registers); every output is float32.
* ``plan`` picks the kernel's regime from the shapes, here in Python so that
  the choice is testable without a card (the C side checks it again): a
  thread per row for the paper's few classes (``rows``), G threads a row,
  from a warp to a block, at larger vocabularies (``group``).
* ``FusionLoss`` is the ``torch.autograd.Function`` that takes the place of
  the JAX package's ``_fusion_core`` custom VJP: the forward saves the
  per-row log-sum-exps, the backward launches the backward kernel and folds
  a broadcast head's gradient back to [K, B, V].
* ``fusion_loss`` / ``fusion_loss_grads`` are the JAX package's one-client
  [M, T, V] entry points; ``fused_multimodal_loss`` is the cohort dict
  front-end with the semantics of ``core.fusion.multimodal_loss`` that the
  cohort step calls for ``loss_backend="pallas"``.

Each kernel wrapper counts its launches in a plain int attribute
(``launch_counts()``), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple

import torch

from ..nvcc import check as _check
from . import ref

MAX_M = 4

__all__ = ["fusion_loss_fwd", "fusion_loss_bwd", "FusionLoss", "fusion_loss",
           "fusion_loss_grads", "fused_multimodal_loss", "plan", "Plan",
           "Launch", "launch_counts", "reset_launch_counts"]

#: blocks in a grid (every plan's shared memory is far below a block's)
MAX_BLOCKS = 2 ** 31 - 1
#: operand types the kernels read, by their C code
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
REGIMES = {"rows": 0, "group": 1}
#: rows regime: ROWS_R rows (one thread each) a block, up to
#: ROWS_FEW_MAX_V classes, or ROWS_MAX_V (the C side's limit) from
#: ROWS_MANY rows of a call on.  Card sweep (tools/ab_fusion_kernels.py
#: --sweep, forward + backward): the rows regime wins at V = 12..16 from
#: 960 rows on and a warp per row from V = 24 at 960 rows (V = 17..23 not
#: timed); at 4096 rows the rows regime wins to V = 48 and ties at 64, at
#: 8192 rows it wins to 64
ROWS_R = 32
ROWS_FEW_MAX_V = 16
ROWS_MAX_V = 64
ROWS_MANY = 4096
#: the rows regime's backward: threads a block, each taking elements
BWD_ROWS_THREADS = 256
#: group regime: G threads a row (several rows a block below 256), CH
#: elements of each operand a thread a chunk; the widths the C side builds
#: for each direction; a forward grid of fewer than FEW_BLOCKS blocks
#: widens rows of FILL_V classes or more up to 256 threads; the backward
#: takes 512 threads a row from WIDE_V classes on
FWD_WIDTHS = (32, 64, 128, 256, 512)
BWD_WIDTHS = (32, 256, 512)
CH = 8
FEW_BLOCKS = 100
FILL_V = 256
WIDE_V = 8192


@dataclass(frozen=True)
class Launch:
    """One direction's launch: its width (rows regime: rows a block;
    group regime: threads a row), the rows and threads of a block,
    the grid's blocks and the block's shared memory in bytes."""
    width: int
    rows: int
    threads: int
    blocks: int
    smem: int


@dataclass(frozen=True)
class Plan:
    """The regime and each direction's launch; the backward writes ``nblk``
    gsq/gdot partials per client (a block never spans two clients)."""
    regime: str
    fwd: Launch
    bwd: Launch
    nblk: int


def smem_bytes(regime: str, backward: bool, width: int, V: int, M: int,
               esize: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the C
    source): rows regime the M staged slabs (R rows and one 16-byte piece
    each), and in the backward the rows' scalars and the per-warp partials;
    group regime the per-warp (max, sum) pairs of a row of several warps
    (forward) or the per-warp partials (backward)."""
    if regime == "rows":
        b = M * 16 * (-(-width * V * esize // 16) + 1)
        if backward:
            b += 4 * width * (3 * M + 4) + 4 * (BWD_ROWS_THREADS // 32) * M * 2
        return b
    warps = group_rows(width) * (width // 32)
    if backward:
        return 4 * warps * M * 2
    return 4 * warps * (M + 1) * 2 if width > 32 else 0


def group_rows(G: int) -> int:
    """Rows a block of the group regime holds at G threads a row."""
    return 1 if G >= 256 else 256 // G


def make_launch(regime: str, backward: bool, width: int, K: int, T: int,
                V: int, M: int, esize: int) -> Launch:
    """One direction's launch of ``regime`` at ``width`` (no choice made);
    raises ValueError for a width the C side does not build."""
    widths = ((ROWS_R,) if regime == "rows"
              else BWD_WIDTHS if backward else FWD_WIDTHS)
    if width not in widths:
        raise ValueError(f"the {regime} regime's "
                         f"{'backward' if backward else 'forward'} takes "
                         f"widths {widths}, not {width}")
    rows = width if regime == "rows" else group_rows(width)
    if regime == "rows":
        threads = BWD_ROWS_THREADS if backward else width
    else:
        threads = width * rows
    return Launch(width, rows, threads, K * -(-T // rows), smem_bytes(
        regime, backward, width, V, M, esize))


def make_plan(regime: str, width: int, K: int, T: int, V: int, M: int,
              esize: int, width_bwd: Optional[int] = None) -> Plan:
    """The launches of ``regime`` at ``width`` (the backward at
    ``width_bwd``, default the width the plan pairs with it)."""
    width_bwd = width_bwd or (bwd_width(width, V) if regime == "group"
                              else width)
    bwd = make_launch(regime, True, width_bwd, K, T, V, M, esize)
    return Plan(regime, make_launch(regime, False, width, K, T, V, M, esize),
                bwd, -(-T // bwd.rows))


def bwd_width(G: int, V: int) -> int:
    """The backward's threads a row of the group regime where the forward
    takes G: a warp where the forward does, else 256, or 512 from WIDE_V
    classes on."""
    return 32 if G == 32 else 512 if V >= WIDE_V else 256


def takes_rows(K: int, T: int, V: int) -> bool:
    """Whether the plan gives K·T rows of V classes a thread each."""
    return V <= ROWS_FEW_MAX_V or (V <= ROWS_MAX_V and K * T >= ROWS_MANY)


@functools.lru_cache(maxsize=256)
def plan(K: int, T: int, V: int, M: int, seg: Tuple[int, ...],
         dtype: torch.dtype) -> Plan:
    """The launches for M operands of ``dtype`` over K clients of T rows of
    V classes (``seg`` the broadcast heads' segment lengths); raises
    ValueError (TypeError for the type) for what no regime takes.

    A few classes (``takes_rows``) go a thread per row, ROWS_R rows a
    block (any V up to ROWS_MAX_V fits a block).  Beyond, the forward takes
    G threads a row, about V / 200 (so that a thread walks tens of chunks
    at an LM vocabulary), from a warp to 512, and up to 256 where fewer
    than FEW_BLOCKS blocks would run on rows of FILL_V classes or more; the
    backward, which also writes M gradients, takes ``bwd_width``.  The
    numbers come from card sweeps (``tools/ab_fusion_kernels.py --sweep``)."""
    if dtype not in DTYPES:
        raise TypeError(f"the CUDA kernels read float32, bfloat16 or "
                        f"float16 operands, got {dtype}")
    if not 1 <= M <= MAX_M:
        raise ValueError(f"the kernels take 1..{MAX_M} modalities, got {M}")
    if min(K, T, V) <= 0 or len(seg) != M or any(s and T % s for s in seg):
        raise ValueError(f"no fusion-loss launch for K={K} T={T} V={V} "
                         f"M={M} seg={seg}")
    esize = dtype.itemsize
    if takes_rows(K, T, V):
        return make_plan("rows", ROWS_R, K, T, V, M, esize)
    G = 32
    while G < FWD_WIDTHS[-1] and 2 * G * 200 <= V:
        G *= 2
    while (G < 256 and V >= FILL_V
           and K * -(-T // group_rows(G)) < FEW_BLOCKS):
        G *= 2
    p = make_plan("group", G, K, T, V, M, esize)
    if max(p.fwd.blocks, p.bwd.blocks) <= MAX_BLOCKS:
        return p
    raise ValueError(f"the fusion-loss kernels take no launch of K={K} "
                     f"T={T} V={V} M={M}: {p.bwd.blocks} blocks exceed the "
                     f"grid")


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------
def _ptrs(tensors, n=MAX_M):
    return [t.data_ptr() for t in tensors] + [None] * (n - len(tensors))


def _kernel_operands(logits, labels, avail, seg):
    """Validate and normalise the operands a kernel launch takes: the
    logits stay in their own type (contiguous), labels become int32 and
    avail float32."""
    M = len(logits)
    if not 1 <= M <= MAX_M:
        raise ValueError(f"the kernels take 1..{MAX_M} modalities, got {M}")
    dev = labels.device
    for x in (*logits, avail):
        if x.device != dev:
            raise ValueError(f"operands on {x.device} and {dev}")
    dt = logits[0].dtype
    for x in logits:
        if x.dtype == torch.float64:
            raise TypeError("the CUDA kernels compute in float32; float64 "
                            "runs only through the plain version on the CPU")
        if x.dtype != dt or dt not in DTYPES:
            raise TypeError(f"the CUDA kernels read operands of one type, "
                            f"float32, bfloat16 or float16; got "
                            f"{[x.dtype for x in logits]}")
    K, T = labels.shape
    V = logits[0].shape[-1]
    lgs = []
    for x, s in zip(logits, seg):
        want = (K, T // s if s else T, V)
        if tuple(x.shape) != want or (s and T % s):
            raise ValueError(f"operand shape {tuple(x.shape)} != {want} "
                             f"(seg={s}, T={T})")
        lgs.append(x.contiguous())
    if tuple(avail.shape) != (M, K, T):
        raise ValueError(f"avail shape {tuple(avail.shape)} != {(M, K, T)}")
    return (lgs, labels.to(torch.int32).contiguous(),
            avail.float().contiguous(), (K, T, V, M))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _plan_for(lgs, seg, shape, p):
    K, T, V, M = shape
    return p or plan(K, T, V, M, tuple(seg), lgs[0].dtype)


def _launch_fwd(lgs, labels, avail, seg, shape, p=None):
    """Forward kernel; ``p`` overrides ``plan``'s launch (card sweeps)."""
    from .build import load
    K, T, V, M = shape
    p = _plan_for(lgs, seg, shape, p)
    # the six outputs are slices of one buffer: one allocation a launch
    buf = torch.empty((3 * (M + 1), K, T), dtype=torch.float32,
                      device=labels.device)
    f_nll, f_max, f_lse, m_nll, m_max, m_lse = buf.split((1, 1, 1, M, M, M))
    f_nll, f_max, f_lse = f_nll[0], f_max[0], f_lse[0]
    segs = list(seg) + [0] * (MAX_M - M)
    with torch.cuda.device(labels.device):
        rc = load().fusion_loss_fwd(
            *_ptrs(lgs), *segs, M, DTYPES[lgs[0].dtype], labels.data_ptr(),
            avail.data_ptr(), K, T, V, REGIMES[p.regime], p.fwd.width,
            f_nll.data_ptr(), m_nll.data_ptr(), f_max.data_ptr(),
            f_lse.data_ptr(), m_max.data_ptr(), m_lse.data_ptr(),
            _stream(labels.device))
    _check(rc, "fusion_loss_fwd")
    _launch_fwd.launches += 1
    return f_nll, m_nll, f_max, f_lse, m_max, m_lse


def _launch_bwd(lgs, labels, avail, d_fused, d_modal, f_lse, m_lse, seg,
                shape, with_partials=True, p=None):
    """Backward kernel: dlogits per modality (float32 slices of one buffer)
    and, ``with_partials``, the per-block gsq/gdot partials [K, nblk, M, 2]
    (else None); ``p`` overrides ``plan``'s launch."""
    from .build import load
    K, T, V, M = shape
    p = _plan_for(lgs, seg, shape, p)
    f32 = dict(dtype=torch.float32, device=labels.device)
    dl = list(torch.empty((M, K, T, V), **f32).unbind(0))
    partials = (torch.empty((K, p.nblk, M, 2), **f32) if with_partials
                else None)
    segs = list(seg) + [0] * (MAX_M - M)
    with torch.cuda.device(labels.device):
        rc = load().fusion_loss_bwd(
            *_ptrs(lgs), *segs, M, DTYPES[lgs[0].dtype], labels.data_ptr(),
            avail.data_ptr(), d_fused.data_ptr(), d_modal.data_ptr(),
            f_lse.data_ptr(), m_lse.data_ptr(), K, T, V, REGIMES[p.regime],
            p.bwd.width, *_ptrs(dl),
            None if partials is None else partials.data_ptr(),
            _stream(labels.device))
    _check(rc, "fusion_loss_bwd")
    _launch_bwd.launches += 1
    return dl, partials


def _launch_reduce(partials):
    """Second stage: gsq/gdot [K, M] summed over blocks in a fixed order."""
    from .build import load
    K, nblk, M, _ = partials.shape
    gsq = torch.empty((K, M), dtype=torch.float32, device=partials.device)
    gdot = torch.empty_like(gsq)
    with torch.cuda.device(partials.device):
        rc = load().fusion_loss_reduce(
            partials.data_ptr(), K, nblk, M, gsq.data_ptr(), gdot.data_ptr(),
            _stream(partials.device))
    _check(rc, "fusion_loss_reduce")
    _launch_reduce.launches += 1
    return gsq, gdot


_launch_fwd.launches = 0
_launch_bwd.launches = 0
_launch_reduce.launches = 0
_KERNELS = {"fusion_loss_fwd": _launch_fwd, "fusion_loss_bwd": _launch_bwd,
            "fusion_loss_reduce": _launch_reduce}


def launch_counts() -> dict:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# one kernel direction: the kernel on CUDA tensors, the plain version on CPU
# ---------------------------------------------------------------------------
def _plain_stack(logits, seg):
    """[M, K, T, V] with broadcast heads expanded to the token grid."""
    return torch.stack([x.repeat_interleave(s, dim=1) if s else x
                        for x, s in zip(logits, seg)])


def _plain_dtype(logits):
    return (torch.float64 if any(x.dtype == torch.float64 for x in logits)
            else torch.float32)


def fusion_loss_fwd(logits: Sequence[torch.Tensor], labels: torch.Tensor,
                    avail: torch.Tensor, seg: Sequence[int]):
    """Forward over a cohort: logits[m] [K, T, V] (or [K, T/S, V] when
    ``seg[m] = S``), labels [K, T], avail [M, K, T].  Returns (fused_nll
    [K, T], modal_nll [M, K, T], fused_max, fused_lse [K, T], modal_max,
    modal_lse [M, K, T])."""
    if labels.is_cuda:
        lgs, lab, av, shape = _kernel_operands(logits, labels, avail, seg)
        return _launch_fwd(lgs, lab, av, seg, shape)
    return ref.fusion_loss_ref(_plain_stack(logits, seg), labels, avail,
                               dtype=_plain_dtype(logits),
                               save_residuals=True)


def fusion_loss_bwd(logits, labels, avail, d_fused, d_modal, f_lse, m_lse,
                    seg, with_partials=True):
    """Backward over a cohort, given the cotangents d_fused [K, T] /
    d_modal [M, K, T] and the forward's log-sum-exps.  Returns (dlogits —
    one [K, T, V] tensor per modality on the token grid, gsq [K, M], gdot
    [K, M]); without ``with_partials`` gsq and gdot are None and the kernel
    writes dlogits only (no reduce launch)."""
    if labels.is_cuda:
        lgs, lab, av, shape = _kernel_operands(logits, labels, avail, seg)
        dl, partials = _launch_bwd(
            lgs, lab, av, d_fused.float().contiguous(),
            d_modal.float().contiguous(), f_lse.contiguous(),
            m_lse.contiguous(), seg, shape, with_partials)
        if not with_partials:
            return dl, None, None
        gsq, gdot = _launch_reduce(partials)
        return dl, gsq, gdot
    d, gsq, gdot = ref.fusion_loss_ref_grads(
        _plain_stack(logits, seg), labels, avail, d_fused, d_modal,
        dtype=_plain_dtype(logits))
    if not with_partials:
        return tuple(d), None, None
    return tuple(d), gsq.T, gdot.T


class FusionLoss(torch.autograd.Function):
    """(fused_nll [K, T], modal_nll [M, K, T]) with the kernel backward.

    ``apply(seg, labels, avail, *logits)``; ``labels`` and ``avail`` get no
    gradient (avail is a mask, not a differentiation surface)."""

    @staticmethod
    def forward(ctx, seg, labels, avail, *logits):
        f_nll, m_nll, _, f_lse, _, m_lse = fusion_loss_fwd(logits, labels,
                                                           avail, seg)
        ctx.seg = tuple(seg)
        ctx.save_for_backward(labels, avail, f_lse, m_lse, *logits)
        return f_nll, m_nll

    @staticmethod
    def backward(ctx, d_fused, d_modal):
        labels, avail, f_lse, m_lse, *logits = ctx.saved_tensors
        dl, _, _ = fusion_loss_bwd(logits, labels, avail, d_fused, d_modal,
                                   f_lse, m_lse, ctx.seg, with_partials=False)
        out = []
        for x, s, d in zip(logits, ctx.seg, dl):
            if s:   # broadcast head: fold the token grid back to [K, B, V]
                d = d.reshape(d.shape[0], -1, s, d.shape[-1]).sum(dim=2)
            out.append(d.to(x.dtype))
        return (None, None, None, *out)


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------
def _one_client(logits, labels, avail):
    M, T, _ = logits.shape
    if avail is None:
        avail = torch.ones((M, T), dtype=torch.float32, device=logits.device)
    return (tuple(logits[i][None] for i in range(M)), labels[None],
            avail[:, None, :], (0,) * M)


def fusion_loss(logits: torch.Tensor, labels: torch.Tensor,
                avail: Optional[torch.Tensor] = None):
    """Differentiable one-pass loss for one client: logits [M, T, V]; labels
    [T]; avail [M, T] (default all-available).  Returns (fused_nll [T],
    modal_nll [M, T])."""
    lgs, lab, av, seg = _one_client(logits, labels, avail)
    f_nll, m_nll = FusionLoss.apply(seg, lab, av, *lgs)
    return f_nll[0], m_nll[:, 0]


def fusion_loss_grads(logits, labels, avail, d_fused, d_modal):
    """Backward as a public op, partials included: given the cotangents
    ``d_fused`` [T] / ``d_modal`` [M, T], returns (dlogits [M, T, V],
    gsq [M], gdot [M]) with gsq_m = ‖dlogits_m‖² and gdot_m = ⟨dlogits_m,
    g_fused⟩ — the Theorem-1 ζ/δ partials in logits space."""
    lgs, lab, av, seg = _one_client(logits, labels, avail)
    _, _, _, f_lse, _, m_lse = fusion_loss_fwd(lgs, lab, av, seg)
    dl, gsq, gdot = fusion_loss_bwd(lgs, lab, av, d_fused[None],
                                    d_modal[:, None], f_lse, m_lse, seg)
    return torch.stack([d[0] for d in dl]), gsq[0], gdot[0]


def fused_multimodal_loss(modal_logits: Mapping[str, torch.Tensor],
                          labels: torch.Tensor,
                          v_weights: Optional[Mapping[str, float]] = None,
                          avail: Optional[Mapping[str, torch.Tensor]] = None,
                          sample_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, dict]:
    """Cohort dict front-end with ``core.fusion.multimodal_loss`` semantics.

    Every input carries a leading cohort axis K: ``modal_logits[m]`` is
    [K, *labels.shape[1:], V] or a broadcast head [K, B, 1, V] against labels
    [K, B, S]; ``avail[m]`` is a per-client 0/1 scalar [K] (per-sample
    vectors stay on ``core.fusion``); ``sample_mask`` is [K, ...] like
    ``labels``.  H_k = F_k + Σ_m v_m·a_{k,m}·G_{k,m} over each client's
    sample-masked mean.  Returns (total [K], {"F", "G_<m>", "G"} each [K])."""
    names = sorted(modal_logits)
    K = labels.shape[0]
    V = modal_logits[names[0]].shape[-1]
    lab = labels.reshape(K, -1)
    T = lab.shape[1]
    lgs, seg = [], []
    for m in names:
        lg = modal_logits[m]
        if lg.shape[:-1] == labels.shape:
            lgs.append(lg.reshape(K, T, V))
            seg.append(0)
        else:               # broadcast head, e.g. [K, B, 1, V] vs [K, B, S]
            lgs.append(lg.reshape(K, -1, V))
            seg.append(int(labels.shape[-1]))
    dev = labels.device
    avs = []
    for m in names:
        a = torch.as_tensor(1.0 if avail is None else avail[m],
                            dtype=torch.float32, device=dev)
        if a.ndim > 1 or (a.ndim == 1 and a.shape[0] != K):
            raise NotImplementedError(
                "fused_multimodal_loss takes a per-client scalar avail [K] "
                "per modality; per-sample vectors stay on core.fusion")
        avs.append(torch.broadcast_to(a, (K,)))
    a_full = torch.stack(avs)[:, :, None].expand(len(names), K, T)

    f_nll, m_nll = FusionLoss.apply(tuple(seg), lab, a_full.contiguous(),
                                    *lgs)

    if sample_mask is None:
        w = torch.ones((K, T), dtype=torch.float32, device=dev)
    else:
        w = torch.broadcast_to(torch.as_tensor(sample_mask, device=dev),
                               labels.shape).reshape(K, T).float()
    w = w.to(f_nll.dtype)
    wsum = torch.clamp_min(w.sum(dim=-1), 1e-9)
    F = (f_nll * w).sum(dim=-1) / wsum
    metrics = {"F": F}
    G = torch.zeros_like(F)
    for i, m in enumerate(names):
        v = 1.0 if v_weights is None else float(v_weights.get(m, 1.0))
        g = v * (m_nll[i] * w).sum(dim=-1) / wsum
        metrics[f"G_{m}"] = g
        G = G + g
    metrics["G"] = G
    return F + G, metrics
