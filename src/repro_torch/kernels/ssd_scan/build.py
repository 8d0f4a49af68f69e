"""Build and load the SSD intra-chunk CUDA kernel (``csrc/ssd_scan.cu``)
through the shared ``kernels.nvcc`` helper."""
from __future__ import annotations

import ctypes
from pathlib import Path

from ..nvcc import CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(Path(__file__).resolve().parent / "csrc"
                      / "ssd_scan.cu", {
    # x, cum, B, C, y_diag, states, Bsz, nc, Q, nh, hp, N, regime, group,
    # stream
    "ssd_chunk_fwd": [_P] * 6 + [_I] * 8 + [_P],
    # regime, group, Q, nh, hp, N
    "ssd_chunk_smem_bytes": [_I] * 6,
    "ssd_chunk_max_smem_bytes": [],
})
build = LIBRARY.build
load = LIBRARY.load
