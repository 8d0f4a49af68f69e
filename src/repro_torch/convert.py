"""Parameters across the package boundary, as numpy.

The port keeps the JAX package's parameter layout (``{modality: {name:
array}}`` with the same leaf names, shapes and layouts), so carrying a
parameter tree across is a leafwise copy: the JAX side hands over
``jax.tree.map(np.asarray, params)`` and gets numpy back the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.trees import tree_map
from .device import resolve_device


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (dtypes kept)."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.as_tensor(np.array(x), device=dev), tree)


def params_to_numpy(params):
    """Nested dict of tensors -> the same dict of numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy(), params)
