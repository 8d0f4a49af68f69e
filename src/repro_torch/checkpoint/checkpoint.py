"""Checkpoints: an npz blob plus a JSON manifest, in the JAX package's two
layouts (``repro/checkpoint/checkpoint.py``), so a checkpoint written by
either package restores in the other.

* **tree** (``save_checkpoint``): one npz entry per leaf.  Leaves are
  keyed by their ``/``-joined dict path, visited in sorted-key order at
  every level (``jax.tree_util``'s order for dicts); list and tuple entries
  are keyed ``#i``.
* **flat** (``save_flat_checkpoint``): one contiguous blob per dtype in the
  ``launch/parambuf`` serving layout, the leaf order and offsets recorded
  under ``manifest["flat"]``.

The manifest records the step, the keys, each leaf's dtype and shape, and
the caller's metadata; ``load_checkpoint`` detects the layout from it and
returns the same nested dict of numpy arrays either way.  Tensors go to
numpy on save; bfloat16 leaves are written as the JAX package's are
(two-byte void in the npz, ``"bfloat16"`` in the manifest) and come back
as two-byte void arrays, which ``convert.params_from_numpy`` takes.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import is_bf16, tensor_to_numpy


def _flatten(tree, prefix: str = "", out=None) -> Dict[str, np.ndarray]:
    out = {} if out is None else out
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    elif tree is None:
        return out
    else:
        leaf = tensor_to_numpy(tree) if isinstance(tree, torch.Tensor) \
            else np.asarray(tree)
        out[prefix] = leaf
        return out
    for k, v in items:
        _flatten(v, f"{prefix}/{k}" if prefix else k, out)
    return out


def _set_path(tree: dict, key: str, value):
    parts = key.split("/")
    cur = tree
    for part in parts[:-1]:
        cur = cur.setdefault(part, {})
    cur[parts[-1]] = value


def save_checkpoint(path: str, tree: Any, step: int = 0,
                    metadata: Optional[dict] = None) -> str:
    """Write ``tree`` as ``ckpt_<step>.npz`` + ``.json`` under ``path``;
    returns the npz file name."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    fn = os.path.join(path, f"ckpt_{step:08d}")
    np.savez(fn + ".npz", **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "dtypes": {k: "bfloat16" if is_bf16(v) else str(v.dtype)
                   for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "metadata": metadata or {},
    }
    with open(fn + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return fn + ".npz"


def save_flat_checkpoint(path: str, tree: Any, step: int = 0,
                         metadata: Optional[dict] = None) -> str:
    """Save through the ``launch/parambuf`` flat layout: one contiguous 1-D
    blob per dtype instead of one npz entry per leaf.  The manifest keeps
    the tree layout's fields (``keys``/``dtypes``/``shapes``);
    ``load_checkpoint`` restores the same nested dict."""
    from ..launch.parambuf import pack_np, spec_of
    os.makedirs(path, exist_ok=True)
    spec = spec_of(tree)
    bufs, _ = pack_np(tree, spec)
    fn = os.path.join(path, f"ckpt_{step:08d}")
    np.savez(fn + ".npz", **{f"flat__{dt}": b for dt, b in bufs.items()})
    manifest = {
        "step": step,
        "keys": sorted(ls.path for ls in spec.leaves),
        "dtypes": {ls.path: ls.dtype for ls in spec.leaves},
        "shapes": {ls.path: list(ls.shape) for ls in spec.leaves},
        "layout": "flat",
        "flat": {
            "order": [[ls.path, list(ls.shape), ls.dtype, ls.offset]
                      for ls in spec.leaves],
            "buffers": {dt: n for dt, n in spec.sizes},
        },
        "metadata": metadata or {},
    }
    with open(fn + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return fn + ".npz"


def load_checkpoint(path: str, step: Optional[int] = None
                    ) -> Tuple[dict, dict]:
    """(tree as nested dicts of numpy arrays, manifest) of the checkpoint
    at ``step`` (default the latest), in either layout.  Lists come back
    as dicts keyed ``#i``."""
    if step is None:
        fn = latest_checkpoint(path)
        if fn is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    else:
        fn = os.path.join(path, f"ckpt_{step:08d}.npz")
    with open(fn[:-4] + ".json") as f:
        manifest = json.load(f)
    tree: dict = {}
    with np.load(fn) as blob:
        if manifest.get("layout") == "flat":
            bufs = {k[len("flat__"):]: blob[k] for k in blob.files}
            for key, shape, dt, off in manifest["flat"]["order"]:
                n = int(np.prod(shape, dtype=np.int64)) if shape else 1
                _set_path(tree, key, bufs[dt][off:off + n].reshape(shape))
            return tree, manifest
        for k in manifest["keys"]:
            _set_path(tree, k, blob[k])
    return tree, manifest


def latest_checkpoint(path: str) -> Optional[str]:
    """The npz file of the highest step under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    pat = re.compile(r"ckpt_(\d+)\.npz$")
    best, best_step = None, -1
    for f in os.listdir(path):
        m = pat.match(f)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(path, f)
    return best
