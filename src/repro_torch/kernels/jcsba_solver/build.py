"""Build and load the JCSBA solver's CUDA kernels (``csrc/jcsba_solver.cu``)
through the shared ``kernels.nvcc`` helper.

The source is built without FMA contraction (``-fmad=false``) on top of the
shared flags (no fast math, no flush-to-zero), so each float32 operation
rounds as the plain version's does."""
from __future__ import annotations

import ctypes
from pathlib import Path

from ..nvcc import CudaLibrary


class SolverArgs(ctypes.Structure):
    """The C side's ``struct SolverArgs``, field for field."""
    _fields_ = [(n, ctypes.c_int) for n in
                ("K", "M", "n_bisect_b", "n_bisect_k")] + \
               [(n, ctypes.c_float) for n in
                ("B_max", "bmax_hi", "bmax_lo", "p_tx", "N0", "n0ln2", "er",
                 "c")]


_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(Path(__file__).resolve().parent / "csrc"
                      / "jcsba_solver.cu", {
    # gamma, h, tau_rem, bmin, ok, args, stream
    "jcsba_bmin": [_P] * 5 + [ctypes.POINTER(SolverArgs), _P],
    # A, bmin, ok, Q, gamma, h, e_cmp, zeta2, delta2, wbar, has, D, V, J,
    # feasible, B, P, threads, cpt, args, stream
    "jcsba_population": [_P] * 16 + [_I] * 3
                        + [ctypes.POINTER(SolverArgs), _P],
}, flags=("-fmad=false",))
build = LIBRARY.build
load = LIBRARY.load
