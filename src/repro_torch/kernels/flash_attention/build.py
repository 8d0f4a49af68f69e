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
    # KH, S, hd, window, stream
    "flash_attention_fwd": [_P] * 4 + [_L] * 12 + [_I] * 7 + [_P],
})
build = LIBRARY.build
load = LIBRARY.load
