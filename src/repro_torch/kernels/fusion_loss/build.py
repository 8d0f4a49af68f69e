"""Build and load the fusion-loss CUDA kernels.

``nvcc`` compiles ``csrc/fusion_loss.cu`` for ``sm_90a`` into a shared
library with a plain C interface at first use, from the sources in this
package only, into ``build/`` beside this file (git-ignored).  The library
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  ``ctypes`` loads it with every
argument type declared (``c_void_p`` for each pointer and the stream).

Nothing here runs at import: the CPU tests import this module on machines
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "fusion_loss.cu"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
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
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the fusion-loss kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def build(verbose: bool = False) -> Path:
    """Compile the library if it is not built yet; returns its path.  With
    ``verbose`` the compiler's output (``-Xptxas -v``: registers, shared
    memory and spills per kernel) is printed."""
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libfusion_loss_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, end="")
    os.replace(tmp, lib)                # atomic: concurrent builders agree
    return lib


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The built library with every function's argument types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
