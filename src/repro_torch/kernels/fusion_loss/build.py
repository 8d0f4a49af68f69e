"""Build and load the fusion-loss CUDA kernels (``csrc/fusion_loss.cu``)
through the shared ``kernels.nvcc`` helper."""
from __future__ import annotations

import ctypes
from pathlib import Path

from ..nvcc import CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(Path(__file__).resolve().parent / "csrc"
                      / "fusion_loss.cu", {
    # x0..x3, seg0..seg3, M, labels, avail, K, T, V, 6 outputs, stream
    "fusion_loss_fwd": [_P] * 4 + [_I] * 5 + [_P, _P] + [_I] * 3
                       + [_P] * 6 + [_P],
    # x0..x3, seg0..seg3, M, labels, avail, d_fused, d_modal, f_lse, m_lse,
    # K, T, V, d0..d3, partials, stream
    "fusion_loss_bwd": [_P] * 4 + [_I] * 5 + [_P] * 6 + [_I] * 3
                       + [_P] * 5 + [_P],
    "fusion_loss_bwd_blocks": [_I],
    # partials, K, nblk, M, gsq, gdot, stream
    "fusion_loss_reduce": [_P, _I, _I, _I, _P, _P, _P],
})
build = LIBRARY.build
load = LIBRARY.load
