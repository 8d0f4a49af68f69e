"""The chunked-SSD forward built on the intra-chunk kernel.

``ssd_chunk(x, cum, Bm, Cm)`` runs one kernel launch on CUDA tensors and the
plain version (``ref.py``) on CPU tensors, and nothing else — a CUDA shape
the kernel cannot take raises.  ``plan`` picks the kernel's regime from the
shapes (small chunks: all heads of a group of chunks per block; large
chunks: tiles of 64 query rows and of N by up to 128 of the hp columns, the
keys streamed), here in Python so that the choice is testable without a
card; the C side checks it again.
``ssd_forward`` has the contract of ``models.mamba2.ssd_chunked``: the
kernel gives the intra-chunk term and the chunk states; the O(S/chunk)
inter-chunk recurrence and the off-diagonal term stay plain torch, as in
the JAX package.  The kernel wrapper counts its launches
(``launch_counts()``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..nvcc import check
from . import ref

#: H100 limits the plan keeps to: shared memory a block may use, blocks in
#: a grid's x dimension, streaming multiprocessors
MAX_SMEM = 232448
MAX_BLOCKS = 2 ** 31 - 1
SM_COUNT = 132
#: small regime: chunks up to 32 rows, 256 threads, at most 8 chunks and
#: 48 KB a block, so that several blocks reside on each SM
SMALL_MAX_Q = 32
SMALL_THREADS = 256
SMALL_MAX_GROUP = 8
SMALL_GROUP_SMEM = 48 * 1024
#: large regime: its query and key tiles; the hp columns go in tiles of
#: 8, 16, 32, 64 or 128
TQ, TS = 64, 32
REGIMES = {"small": 0, "large": 1}


@dataclass(frozen=True)
class Plan:
    """One launch: the regime, the chunks per block (small regime), the
    block's threads, the grid's blocks and the block's shared memory."""
    regime: str
    group: int
    threads: int
    blocks: int
    smem: int


def _ru4(n: int) -> int:
    return -(-n // 4) * 4


def small_smem(G: int, Q: int, nh: int, hp: int, N: int) -> int:
    """Bytes of shared memory a small-regime block of G chunks needs (the
    layout of ``ssd_small_kernel``)."""
    return 4 * (_ru4(G * Q * nh * hp) + _ru4(G * Q * nh) + 2 * _ru4(G * Q * N)
                + G * Q * Q + G * nh * Q + G * nh * (Q * Q + 1))


def large_hp_tile(hp: int) -> int:
    """The column tile HP of ``ssd_large_kernel<HP>`` for head dim hp: the
    least of 8, 16, 32, 64, 128 that covers it, else 128."""
    return min(128, max(8, 1 << (hp - 1).bit_length()))


def large_layout(hp: int):
    """(threads, state rows per block) of the large-regime kernel for hp."""
    HP = large_hp_tile(hp)
    rt = 4 if HP >= 64 else (2 if HP == 32 else 1)
    ty = TQ // rt
    return HP // 4 * ty, 4 * ty


def large_smem(hp: int, N: int) -> int:
    """Bytes of shared memory a large-regime block needs: the larger of a y
    block (C tile, two B/x/cum stages, the score tile) and a state block
    (two B/x/decay stages); N padded to a multiple of 4."""
    HP, NT = large_hp_tile(hp), large_layout(hp)[1]
    NP = _ru4(N) + 4
    yb = TQ * NP + TQ + 2 * (TS * NP + TS * HP + TS) + TQ * (TS + 1)
    sb = 2 * (TS * (NT + 4) + TS * HP + TS)
    return 4 * max(yb, sb)


def large_blocks(R: int, Q: int, nh: int, hp: int, N: int) -> int:
    """Blocks of a large-regime launch: y blocks and state blocks for each
    chunk, head and column tile."""
    per = R * nh * -(-hp // large_hp_tile(hp))
    return per * (-(-Q // TQ) + -(-N // large_layout(hp)[1]))


def _large_takes(hp: int, N: int) -> bool:
    return large_smem(hp, N) <= MAX_SMEM


def plan(Bsz: int, nc: int, Q: int, nh: int, hp: int, N: int) -> Plan:
    """The launch for x [Bsz, nc, Q, nh, hp] and B/C [.., N]; raises
    ValueError for a shape no regime takes."""
    R = Bsz * nc
    # a few chunks of 16 rows or more spread wider as large-regime tiles
    # (one block per chunk and head and tile) than as small-regime groups
    few = Q >= 16 and R < SM_COUNT // 2
    if Q <= SMALL_MAX_Q and not (few and _large_takes(hp, N)):
        one = small_smem(1, Q, nh, hp, N)
        if one <= MAX_SMEM:
            G = max(1, min(SMALL_MAX_GROUP, R // (SM_COUNT * 8),
                           SMALL_GROUP_SMEM // one))
            blocks = -(-R // G)
            if blocks <= MAX_BLOCKS:
                return Plan("small", G, SMALL_THREADS, blocks,
                            small_smem(G, Q, nh, hp, N))
    blocks = large_blocks(R, Q, nh, hp, N)
    if _large_takes(hp, N) and blocks <= MAX_BLOCKS:
        return Plan("large", 1, large_layout(hp)[0], blocks,
                    large_smem(hp, N))
    raise ValueError(
        f"the SSD chunk kernel takes no chunk of Q={Q}, nh={nh}, hp={hp}, "
        f"N={N} at {R} chunks: it takes chunks of up to {SMALL_MAX_Q} rows "
        f"whose heads fit {MAX_SMEM} bytes of shared memory, and any chunk "
        f"whose 64-row tiles, with N padded to a multiple of 4, fit it")


def _launch(x, cum, Bm, Cm):
    """One kernel launch on CUDA tensors: (y_diag, states), float32."""
    from .build import load
    if x.dim() != 5 or cum.shape != x.shape[:4] or Bm.shape != Cm.shape \
            or Bm.shape[:3] != x.shape[:3]:
        raise ValueError(f"x {tuple(x.shape)}, cum {tuple(cum.shape)}, "
                         f"B {tuple(Bm.shape)}, C {tuple(Cm.shape)}: expected "
                         f"[B,nc,Q,nh,hp], [B,nc,Q,nh], [B,nc,Q,N] twice")
    for t in (x, cum, Bm, Cm):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel computes in float32, got "
                            f"{t.dtype}; float64 runs only through the plain "
                            f"version on the CPU")
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
    Bsz, nc, Q, nh, hp = x.shape
    N = Bm.shape[-1]
    p = plan(Bsz, nc, Q, nh, hp, N)
    lib = load()
    # 16-byte copies: a contiguous view at an odd offset is copied first
    x, cum, Bm, Cm = (t.contiguous() if t.data_ptr() % 16 == 0
                      else t.contiguous().clone() for t in (x, cum, Bm, Cm))
    y = torch.empty_like(x)
    st = torch.empty((Bsz, nc, nh, N, hp), dtype=torch.float32,
                     device=x.device)
    if x.numel() == 0:
        return y, st
    with torch.cuda.device(x.device):
        rc = lib.ssd_chunk_fwd(
            x.data_ptr(), cum.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), st.data_ptr(), Bsz, nc, Q, nh, hp, N,
            REGIMES[p.regime], p.group,
            torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "ssd_chunk_fwd")
    _launch.launches += 1
    return y, st


_launch.launches = 0


def launch_counts() -> dict:
    """Launches of the kernel since the last ``reset_launch_counts``."""
    return {"ssd_chunk_fwd": _launch.launches}


def reset_launch_counts() -> None:
    _launch.launches = 0


def ssd_chunk(x, cum, Bm, Cm):
    """x: [B,nc,Q,nh,hp] (dt-weighted), cum: [B,nc,Q,nh], Bm/Cm:
    [B,nc,Q,N] -> (y_diag [B,nc,Q,nh,hp], states [B,nc,nh,N,hp])."""
    if x.is_cuda:
        return _launch(x, cum, Bm, Cm)
    return ref.ssd_chunk_ref(x, cum, Bm, Cm)


def ssd_forward(x, dt, A, Bm, Cm, chunk: int, return_state: bool = False):
    """Same contract as ``models.mamba2.ssd_chunked``.

    x: [B,S,nh,hp]; dt: [B,S,nh] fp32; A: [nh] or per batch row [B,nh];
    Bm/Cm: [B,S,N].  Returns y [B,S,nh,hp] in x's type; with
    ``return_state`` also the recurrence's final state [B,nh,N,hp] fp32."""
    Bsz, S, nh, hp = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"chunk {Q} does not divide S={S}")
    nc = S // Q
    xd = x.float() * dt[..., None]
    dtA = dt * A.unsqueeze(-2)
    cum = torch.cumsum(dtA.reshape(Bsz, nc, Q, nh), dim=2)
    xc = xd.reshape(Bsz, nc, Q, nh, hp)
    Bc = Bm.float().reshape(Bsz, nc, Q, N)
    Cc = Cm.float().reshape(Bsz, nc, Q, N)

    y_diag, states = ssd_chunk(xc, cum, Bc, Cc)

    chunk_decay = torch.exp(cum[:, :, -1, :])                    # [B,nc,nh]
    h = x.new_zeros((Bsz, nh, N, hp), dtype=torch.float32)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                          # [B,nc,nh,N,hp]
    y_off = torch.einsum("bctn,bcth,bchnp->bcthp", Cc, torch.exp(cum), h_prev)
    y = (y_diag + y_off).reshape(Bsz, S, nh, hp).to(x.dtype)
    return (y, h) if return_state else y
