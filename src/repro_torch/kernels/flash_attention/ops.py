"""The flash-attention kernel's front end in the model's layout.

``flash_attention(q, k, v)`` takes q [B, S, H, hd] and k/v [B, S, KH, hd]
(``models.layers``' layout) and returns [B, S, H, hd]: the CUDA kernel for
CUDA tensors, the plain version (``ref.py``) for CPU tensors, and nothing
else — a CUDA tensor the kernel cannot take raises.  The kernel reads its
operands through their strides (head dim contiguous), so the layout needs
no transpose on the card.  The wrapper counts its launches
(``launch_counts()``), so a run can show that it went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..nvcc import check
from . import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 256


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
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        rc = load().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *strides,
            _DTYPES[q.dtype], B, H, KH, S, hd, window or 0,
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
