"""Device resolution: the port runs on the card unless told otherwise;
and CUDA graph capture safe from Python's garbage collector."""
from __future__ import annotations

import contextlib
import gc

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises ``RuntimeError`` for a CUDA
    device when no card is present (no quiet fallback to the CPU — pass
    ``device="cpu"`` to run the plain versions there)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def graph_capture(graph, pool=None):
    """``torch.cuda.graph(graph, pool=pool)`` with Python's cyclic garbage
    collected just before and the collector paused until the capture ends.
    A dead reference cycle that holds CUDA objects (a server's decode
    graph, a round engine's graphs), collected by the automatic collector
    in the middle of a capture, frees them on the capturing thread and
    invalidates the capture (``cudaErrorStreamCaptureInvalidated``); the
    graph context itself no longer collects before it begins."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            yield
    finally:
        if enabled:
            gc.enable()
