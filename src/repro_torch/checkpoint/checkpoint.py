"""Tree checkpoints: an npz blob plus a JSON manifest — the JAX package's
tree layout (``repro/checkpoint/checkpoint.py``), so a checkpoint written
by either package restores in the other.

Leaves are keyed by their ``/``-joined dict path, visited in sorted-key
order at every level (``jax.tree_util``'s order for dicts); list and tuple
entries are keyed ``#i``.  Tensors go to numpy on save.  The manifest
records the step, the keys, each leaf's dtype and shape, and the caller's
metadata.  The JAX package's flat serving layout (``save_flat_checkpoint``)
is not ported yet.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "", out=None) -> Dict[str, np.ndarray]:
    out = {} if out is None else out
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    elif tree is None:
        return out
    else:
        leaf = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
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
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "metadata": metadata or {},
    }
    with open(fn + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return fn + ".npz"


def load_checkpoint(path: str, step: Optional[int] = None
                    ) -> Tuple[dict, dict]:
    """(tree as nested dicts of numpy arrays, manifest) of the checkpoint
    at ``step`` (default the latest).  Lists come back as dicts keyed
    ``#i``.  Refuses the JAX package's flat layout."""
    if step is None:
        fn = latest_checkpoint(path)
        if fn is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    else:
        fn = os.path.join(path, f"ckpt_{step:08d}.npz")
    with open(fn[:-4] + ".json") as f:
        manifest = json.load(f)
    if manifest.get("layout") == "flat":
        raise NotImplementedError(
            "flat-layout checkpoints (save_flat_checkpoint) are not ported "
            "yet; ROADMAP.md Queue 1 item 9")
    tree: dict = {}
    with np.load(fn) as blob:
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
