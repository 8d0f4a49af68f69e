"""Build and load one CUDA source as a shared library with a C interface.

Each kernel package (``fusion_loss``, ``flash_attention``, ``ssd_scan``,
``jcsba_solver``) keeps its ``csrc/<name>.cu`` and a ``build.py`` that declares a
``CudaLibrary``.  ``nvcc`` compiles the source for ``sm_90a`` at first use,
from the sources in this repository only, into ``build/`` beside the
package (git-ignored).  The library name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded.  ``ctypes`` loads it with every argument type declared
(``c_void_p`` for each pointer and the stream).

Nothing here runs at import: the CPU tests import the kernel packages on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit on PATH or under CUDA_HOME")


class CudaLibrary:
    """One ``.cu`` source, its build into ``build/`` and its ctypes
    handle.  ``signatures`` maps each exported function to its argument
    types; every function returns a C ``int`` (a ``cudaError_t``, or a
    negative code for arguments the kernel refuses).  ``flags`` are added
    to ``NVCC_FLAGS`` for this source only."""

    def __init__(self, source: Path, signatures: Dict[str, List],
                 flags: Sequence[str] = ()):
        self.source = Path(source)
        self.build_dir = self.source.parent.parent / "build"
        self.signatures = signatures
        self.flags = (*NVCC_FLAGS, *flags)
        self._lib = None

    def build(self, verbose: bool = False) -> Path:
        """Compile the library if it is not built yet; returns its path.
        With ``verbose`` the compiler's output (``-Xptxas -v``: registers,
        shared memory and spills per kernel) is printed in one piece."""
        digest = hashlib.sha1(self.source.read_bytes()
                              + " ".join(self.flags).encode()).hexdigest()
        lib = self.build_dir / f"lib{self.source.stem}_{digest[:16]}.so"
        if lib.exists():
            return lib
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        if verbose:
            print(f"[build] {self.source.name}\n{res.stdout}{res.stderr}",
                  end="", flush=True)
        os.replace(tmp, lib)            # atomic: concurrent builds agree
        return lib

    def load(self) -> ctypes.CDLL:
        """The built library with every function's argument types
        declared (built and loaded once per process)."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned an error code."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + (f"cudaError {rc}" if rc > 0
                              else f"arguments refused (code {rc})"))
