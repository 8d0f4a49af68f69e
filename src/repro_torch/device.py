"""Device resolution: the port runs on the card unless told otherwise."""
from __future__ import annotations

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
