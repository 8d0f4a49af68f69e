"""Parameters across the package boundary, as numpy.

The port keeps the JAX package's parameter layout (``{modality: {name:
array}}`` with the same leaf names, shapes and layouts, nested to any
depth — the encoder and LM trees' ``blocks/l{i}/...`` leaves keep their
leading ``n_blocks`` axis), so carrying a parameter tree across is a
leafwise copy: the JAX side hands over ``jax.tree.map(np.asarray,
params)`` and gets numpy back the same way.  ``tree_leaves`` visits the
result in ``jax.tree.leaves`` order (sorted keys at every level).

bfloat16 leaves: numpy has no bfloat16 of its own.  The JAX package's are
``ml_dtypes.bfloat16`` arrays, which ``np.savez`` writes (and ``np.load``
reads back) as two-byte void, descr ``'<V2'``.  The port takes either
without importing ``ml_dtypes``: it reinterprets the two bytes as int16 and
views the tensor as ``torch.bfloat16``.  Going the other way a bfloat16
tensor becomes a ``'<V2'`` array of the same bytes, what ``np.savez``
writes for the JAX package's bfloat16 leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.trees import tree_map
from .device import resolve_device

#: numpy's two-byte void: how a bfloat16 array reads back from an npz
BF16_VOID = np.dtype("V2")


def is_bf16(a: np.ndarray) -> bool:
    """A numpy array of bfloat16 values (``ml_dtypes.bfloat16`` or the
    two-byte void an npz gives back)."""
    return a.dtype.name == "bfloat16" or a.dtype == BF16_VOID


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One numpy leaf -> a tensor on ``device`` (dtype kept; bfloat16 from
    either numpy form)."""
    a = np.asarray(a)
    if is_bf16(a):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def as_tensor(leaf) -> torch.Tensor:
    """A tensor leaf as it is; a numpy leaf through ``tensor_from_numpy``
    (on the CPU)."""
    return leaf if isinstance(leaf, torch.Tensor) else tensor_from_numpy(leaf)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> numpy; a bfloat16 tensor as its bytes in ``'<V2'``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_VOID)
    return t.numpy()


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (dtypes kept)."""
    dev = resolve_device(device)
    return tree_map(lambda x: tensor_from_numpy(x, dev), tree)


def params_to_numpy(params):
    """Nested dict of tensors -> the same dict of numpy arrays."""
    return tree_map(tensor_to_numpy, params)
