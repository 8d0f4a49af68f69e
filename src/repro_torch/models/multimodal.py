"""Unimodal classification encoders for the FL backbone adapter
(``fl/client.py``), on per-client stacks.

A small sequence encoder — linear projection, the ``cfg`` block stack,
final norm, head — maps one modality's feature stack [K, B, T, *feat] to
C-class decision logits, in the role of the paper's LSTM/CNN submodels but
with the transformer / Mamba2 blocks (``ENCODER_PRESETS``).  Fusion and the
loss are shared with the paper models (``core.fusion``,
``kernels/fusion_loss``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.trees import tree_map
from . import transformer as T
from .config import ModelConfig
from .layers import dense
from .paper_models import dropout_keep


def init_encoder(gen: torch.Generator, d_in: int, n_classes: int,
                 cfg: ModelConfig):
    """One encoder's global params (no cohort axis): ``blocks`` leaves
    stacked [n_blocks, ...], with the JAX package's leaf names."""
    pattern = cfg.block_pattern()
    dt = cfg.param_dtype
    per_block = [{f"l{i}": T.init_layer(gen, cfg, spec)
                  for i, spec in enumerate(pattern)}
                 for _ in range(cfg.n_blocks)]

    return {
        "proj": {"w": (torch.randn((d_in, cfg.d_model), generator=gen)
                       / math.sqrt(d_in)).to(dt),
                 "b": torch.zeros((cfg.d_model,), dtype=dt)},
        "blocks": tree_map(lambda *xs: torch.stack(xs), *per_block),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt),
        "head": {"w": (torch.randn((cfg.d_model, n_classes), generator=gen)
                       / math.sqrt(cfg.d_model)).to(dt),
                 "b": torch.zeros((n_classes,), dtype=dt)},
    }


def encoder_apply(p, x, cfg: ModelConfig, *,
                  dropout_keys: Optional[torch.Tensor] = None,
                  dropout: float = 0.1, remat: bool = False,
                  impl: str = "xla"):
    """x: [K, B, T, *feat] -> logits [K, B, C].

    Trailing feature dims are flattened per time step (an image stack
    [K, B, 32, 32, 3] becomes a 32-step sequence of 96-dim rows).  Dropout
    (``dropout_keys`` [K], the per-client modality stream keys; ``None`` =
    none) acts on the pooled last-position representation with per-sample
    masks, so sample i's mask depends only on (key, i), never on the batch
    size — the same discipline as ``paper_models.lstm_apply``."""
    K, B, S = x.shape[:3]
    h = dense(p["proj"], x.reshape(K, B, S, -1))
    h = T.backbone(p, h, cfg, attn_chunk=S, remat=remat, impl=impl)
    h = h[:, :, -1, :]                                       # [K, B, D]
    if dropout_keys is not None and dropout > 0.0:
        keep = dropout_keep(dropout_keys, B, h.shape[2:], dropout)
        h = torch.where(keep, h / (1.0 - dropout), torch.zeros_like(h))
    return dense(p["head"], h)
