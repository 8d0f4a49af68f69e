"""The chunked-SSD forward built on the intra-chunk kernel.

``ssd_chunk(x, cum, Bm, Cm)`` runs one kernel launch on CUDA tensors and the
plain version (``ref.py``) on CPU tensors, and nothing else — a CUDA shape
the kernel cannot take raises.  ``ssd_forward`` has the contract of
``models.mamba2.ssd_chunked``: the kernel gives the intra-chunk term and the
chunk states; the O(S/chunk) inter-chunk recurrence and the off-diagonal
term stay plain torch, as in the JAX package.  The kernel wrapper counts
its launches (``launch_counts()``).
"""
from __future__ import annotations

import torch

from ..nvcc import check
from . import ref


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
    lib = load()
    need, room = lib.ssd_chunk_smem_bytes(Q, hp, N), \
        lib.ssd_chunk_max_smem_bytes()
    if need > room:
        raise ValueError(f"chunk Q={Q}, hp={hp}, N={N} needs {need} bytes of "
                         f"shared memory per block, more than the {room} a "
                         f"block may use; use a smaller chunk")
    x, cum, Bm, Cm = (t.contiguous() for t in (x, cum, Bm, Cm))
    y = torch.empty_like(x)
    st = torch.empty((Bsz, nc, nh, N, hp), dtype=torch.float32,
                     device=x.device)
    if x.numel() == 0:
        return y, st
    with torch.cuda.device(x.device):
        rc = lib.ssd_chunk_fwd(
            x.data_ptr(), cum.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), st.data_ptr(), Bsz, nc, Q, nh, hp, N,
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


def ssd_forward(x, dt, A, Bm, Cm, chunk: int):
    """Same contract as ``models.mamba2.ssd_chunked``.

    x: [B,S,nh,hp]; dt: [B,S,nh] fp32; A: [nh] or per batch row [B,nh];
    Bm/Cm: [B,S,N].  Returns y [B,S,nh,hp] in x's type."""
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
    return (y_diag + y_off).reshape(Bsz, S, nh, hp).to(x.dtype)
