"""Build and load the flash-attention CUDA kernel
(``csrc/flash_attention.cu``) through the shared ``kernels.nvcc`` helper."""
from __future__ import annotations

import ctypes
from pathlib import Path

from ..nvcc import CudaLibrary

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary(Path(__file__).resolve().parent / "csrc"
                      / "flash_attention.cu", {
    # q, k, v, o, 12 element strides (b, s, h of q, k, v, o), dtype, B, H,
    # KH, S, hd, window, regime, heads per block (short) or key splits
    # (long), row groups and key tile (long), stream
    "flash_attention_fwd": [_P] * 4 + [_L] * 12 + [_I] * 11 + [_P],
    # regime, dtype, S, hd, heads per block or key splits, H / KH, key tile
    "flash_attention_smem_bytes": [_I] * 7,
})
build = LIBRARY.build
load = LIBRARY.load
