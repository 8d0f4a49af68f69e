"""The flash-attention kernel's front end in the model's layout.

``flash_attention(q, k, v)`` takes q [B, S, H, hd] and k/v [B, S, KH, hd]
(``models.layers``' layout) and returns [B, S, H, hd]: the CUDA kernel for
CUDA tensors, the plain version (``ref.py``) for CPU tensors, and nothing
else — a CUDA tensor the kernel cannot take raises.  The kernel reads its
operands through their strides (head dim contiguous), so the layout needs
no transpose on the card.  ``plan`` picks the kernel's regime from the
shapes — short sequences a lane per query row, long ones 64-row tiles on
the tensor cores (bfloat16) or in FFMA (float32), bfloat16 at hd 112 and
256 the wide tiles on the tensor cores, float32 or unaligned operands at
any other head dim the generic tiles — here in Python so that the choice
is testable without a card; the C side checks it again.  The wrapper
counts its launches (``launch_counts()``), so a run can show that it went
through the kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..nvcc import check
from . import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 256
#: H100 limits the plan keeps to: shared memory a block may use, blocks in
#: a grid's x dimension
MAX_SMEM = 232448
MAX_BLOCKS = 2 ** 31 - 1
#: short regime: S up to 64, these head dims, at most 16 warps a block
SHORT_MAX_S = 64
SHORT_HD = (8, 16, 32)
SHORT_MAX_THREADS = 512
#: long regime: these head dims; bfloat16 (tensor cores) in key tiles of
#: 64, a warp per 16 query rows and key split (``mma_layout``); float32
#: (FFMA) in blocks of 64 query rows and key tiles of 32 with 4 warps
LONG_HD = (16, 32, 64, 128)
LQ, MMA_BK, FMA_BK, LONG_THREADS = 64, 64, 32, 128
SM_COUNT = 132
#: wide regime (bfloat16 on the tensor cores, 16-byte aligned operands):
#: head dim -> warps a block (16 query rows each, serving the query heads
#: of one KV head that divide both the warps and H / KH); key tiles of 64
WIDE_WARPS = {112: 4, 256: 8}
WIDE_BK = 64
#: generic regime (float32, or unaligned operands, at a head dim no other
#: regime takes): 32 query rows, 32 keys, 128 threads a block
G_BQ, G_BK, G_THREADS = 32, 32, 128
REGIMES = {"short": 0, "long": 1, "generic": 2, "wide": 3}


@dataclass(frozen=True)
class Plan:
    """One launch: the regime, the query heads of a short or wide block,
    the key splits, 16-row groups and key tile of a long bfloat16 block
    (a wide block's warps a head and key tile), the block's threads, the
    grid's blocks and the block's shared memory."""
    regime: str
    heads_per_block: int
    key_splits: int
    row_groups: int
    key_tile: int
    threads: int
    blocks: int
    smem: int

    @property
    def c_arg(self) -> int:
        """The kernel's per-regime argument: heads per block (short,
        wide), key splits (long)."""
        return self.key_splits if self.regime == "long" else \
            self.heads_per_block


def short_hpw(hpb: int) -> int:
    """Heads a short-regime warp covers: the largest power of two dividing
    the block's heads, at most 8 (a lane per (query row, head))."""
    w = 1
    while w < 8 and hpb % (2 * w) == 0:
        w *= 2
    return w


def short_threads(S: int, hpb: int) -> int:
    """Threads of a short-regime block of ``hpb`` heads: per group of
    ``short_hpw`` heads, one warp per 32/hpw query rows."""
    hpw = short_hpw(hpb)
    rpw = 32 // hpw
    return hpb // hpw * -(-S // rpw) * 32


def mma_layout(B: int, S: int, H: int, hd: int,
               window: Optional[int] = None):
    """(row groups, key splits, key tile) of a long bfloat16 block.  A grid
    of many blocks takes 64 query rows a block, one key split and 64-key
    tiles.  A small grid (a short sequence, few heads) is bound by its
    longest block's chain of key tiles, so it splits the keys: up to hd 64
    (where four splits' K/V stages fit shared memory) 32 query rows and
    four splits, of 32-key tiles where the block sees at most three 64-key
    tiles; above, 64 rows and two splits."""
    if B * H * -(-S // LQ) >= 4 * SM_COUNT:
        return 4, 1, MMA_BK
    span = S if window is None else min(S, window + 31)
    tiles = -(-span // MMA_BK) + (0 if window is None else 1)
    if tiles <= 1:
        return (4 if hd > 64 else 2), 1, MMA_BK
    if hd > 64:
        return 4, 2, MMA_BK
    return 2, 4, (32 if tiles <= 3 else MMA_BK)


def smem_bytes(regime: str, dtype: torch.dtype, S: int, hd: int,
               hpb: int = 1, R: int = 1, ks: int = 1, bk: int = MMA_BK) -> int:
    """Bytes of shared memory one block of the regime needs (the layouts
    of the kernels in ``csrc/flash_attention.cu``)."""
    esz = 2 if dtype == torch.bfloat16 else 4
    if regime == "short":      # K and V of the block's KV heads, padded
        return 2 * (hpb // R if hpb >= R else 1) * (esz * S * hd + 16)
    if regime == "long" and dtype == torch.bfloat16:
        return 2 * (4 * ks * bk + 64) * (hd + 8)
    if regime == "long":
        return 4 * (LQ * (hd + 4) + 2 * FMA_BK * (hd + 4) + 2 * FMA_BK * hd
                    + LQ * (FMA_BK + 1))
    if regime == "wide":       # the block's query rows, two stages of K/V
        return 2 * (16 * WIDE_WARPS[hd] + 4 * WIDE_BK) * (hd + 8)
    return 4 * (G_BQ * hd + G_BK * (hd + 1) + G_BK * hd + G_BQ * (G_BK + 1)
                + G_BQ * hd + 3 * G_BQ)


def aligned16(tensors, hd: int) -> bool:
    """Every pointer and every stride 16-byte aligned, and a head-dim row
    a whole number of 16-byte pieces: what the long and wide regimes'
    copies need."""
    return all(t.data_ptr() % 16 == 0
               and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])
               and hd * t.element_size() % 16 == 0 for t in tensors)


def plan(B: int, S: int, H: int, KH: int, hd: int, dtype: torch.dtype,
         aligned: bool = True, window: Optional[int] = None) -> Plan:
    """The launch for q [B, S, H, hd] and k/v [B, S, KH, hd] of ``dtype``;
    ``aligned`` says whether the operands are 16-byte aligned
    (``aligned16``).  Raises ValueError for a shape no regime takes."""
    R = H // KH
    if S <= SHORT_MAX_S and hd in SHORT_HD:
        hpb = max(d for d in range(1, H + 1)
                  if H % d == 0 and (d % R == 0 or R % d == 0)
                  and short_threads(S, d) <= SHORT_MAX_THREADS)
        smem = smem_bytes("short", dtype, S, hd, hpb, R)
        if smem <= MAX_SMEM and B * (H // hpb) <= MAX_BLOCKS:
            return Plan("short", hpb, 1, 0, 0, short_threads(S, hpb),
                        B * (H // hpb), smem)
    if hd in LONG_HD and aligned:
        if dtype == torch.bfloat16:
            rg, ks, bk = mma_layout(B, S, H, hd, window)
        else:
            rg, ks, bk = LQ // 16, 1, FMA_BK
        blocks = B * H * -(-S // (16 * rg))
        if blocks <= MAX_BLOCKS:
            return Plan("long", 1, ks, rg, bk, 32 * rg * ks, blocks,
                        smem_bytes("long", dtype, S, hd, ks=ks, bk=bk))
    if hd in WIDE_WARPS and dtype == torch.bfloat16 and aligned:
        warps = WIDE_WARPS[hd]
        hpb = max(d for d in (1, 2, 4, 8) if warps % d == 0 and R % d == 0)
        rg = warps // hpb
        blocks = B * KH * (R // hpb) * -(-S // (16 * rg))
        if blocks <= MAX_BLOCKS:
            return Plan("wide", hpb, 1, rg, WIDE_BK, 32 * warps, blocks,
                        smem_bytes("wide", dtype, S, hd))
    blocks = B * H * -(-S // G_BQ)
    if hd <= MAX_HD and blocks <= MAX_BLOCKS:
        return Plan("generic", 1, 1, 0, 0, G_THREADS, blocks,
                    smem_bytes("generic", dtype, S, hd))
    raise ValueError(f"the attention kernel takes no B={B}, S={S}, H={H}, "
                     f"hd={hd}: head dims up to {MAX_HD} and at most "
                     f"{MAX_BLOCKS} blocks")


def _launch(q, k, v, window: Optional[int]):
    """One kernel launch on CUDA tensors in the [B, S, H, hd] layout."""
    from .build import load
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected [B, S, H, hd] and "
                         f"[B, S, KH, hd]")
    B, S, H, hd = q.shape
    KH = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, hd) or H % KH:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not form GQA attention (H % KH == 0)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 q/k/v of "
                        f"one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HD}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    p = plan(B, S, H, KH, hd, q.dtype, aligned16((q, k, v, o), hd), window)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        rc = load().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *strides,
            _DTYPES[q.dtype], B, H, KH, S, hd, window or 0,
            REGIMES[p.regime], p.c_arg, p.row_groups, p.key_tile,
            torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "flash_attention_fwd")
    _launch.launches += 1
    return o


_launch.launches = 0


def launch_counts() -> dict:
    """Launches of the kernel since the last ``reset_launch_counts``."""
    return {"flash_attention_fwd": _launch.launches}


def reset_launch_counts() -> None:
    _launch.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal attention.  q: [B, S, H, hd]; k/v: [B, S, KH, hd] ->
    [B, S, H, hd], in q's type."""
    if q.is_cuda:
        return _launch(q, k, v, window)
    return ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2),
                             window=window).transpose(1, 2)
