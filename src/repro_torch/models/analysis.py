"""Analytic FLOPs / parameter accounting: the port of the JAX package's
``models/analysis.py``, walking the port's dict trees.

MODEL_FLOPS: 6·N·D for dense training (N = params, D = tokens),
6·N_active·D for MoE; prefill 2·N_active a token, decode 2·N_active a
generated token.  An expert tensor (``ffn/(wg|wu|wd)``, [E, ., .] in one
layer) counts ``top_k / n_experts`` of its params as active.

The LM trees stack their blocks on a leading ``n_blocks`` axis, so an
expert tensor there is [n_blocks, E, ., .].  The JAX package's rule asks
for three axes and so counts every stacked expert as active (its
N_active equals N_total for every MoE config); the port takes the
``blocks/`` axis off before it counts, which gives the configs' names —
llama4-scout-17b-a16e: about 17 B active.
"""
from __future__ import annotations

import re
from typing import NamedTuple, Tuple

_EXPERT_RE = re.compile(r"ffn/(wg|wu|wd)$")


class StepShape(NamedTuple):
    """One step's input shape, with the JAX package's ``InputShape``
    field names: ``kind`` is ``train``, ``prefill`` or ``decode``."""
    seq_len: int
    global_batch: int
    kind: str


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def param_counts(params_shape, cfg) -> Tuple[int, int]:
    """(N_total, N_active) of a params tree (meta tensors will do)."""
    total = 0
    active = 0
    for path, leaf in _leaves_with_paths(params_shape):
        n = leaf.numel()
        total += n
        layer_dims = leaf.dim() - path.startswith(("blocks/", "enc_blocks/",
                                                   "dec_blocks/"))
        if _EXPERT_RE.search(path) and layer_dims == 3 and cfg.n_experts > 0:
            active += n * cfg.top_k // cfg.n_experts
        else:
            active += n
    return total, active


def model_flops(cfg, params_shape, shape) -> dict:
    """MODEL_FLOPS for one step of ``shape`` (a ``StepShape`` or anything
    with its fields)."""
    n_total, n_active = param_counts(params_shape, cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        flops = 6 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = B * S
        flops = 2 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = B
        flops = 2 * n_active * tokens
    return {"n_params": int(n_total), "n_active": int(n_active),
            "tokens": int(tokens), "model_flops": int(flops)}
