"""The encoder's layer stack: ``n_blocks`` repetitions of the config's
super-block (``ModelConfig.block_pattern``), with per-block params stacked
on an axis after the cohort axis — leaves [K, n_blocks, ...].

The JAX package scans the blocks with ``lax.scan``; here ``backbone`` loops
over them.  With ``remat`` each block runs under non-reentrant
``torch.utils.checkpoint``: its activations are recomputed in the backward
(and a kernel-path block launches its mixer kernel again there).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..core.trees import tree_map
from . import layers as L
from .config import LayerSpec, ModelConfig
from .mamba2 import init_mamba, mamba_fwd

_MOE_QUEUED = ("MoE layers are not ported yet; models/moe.py is queued in "
               "ROADMAP.md Queue 1 item 10")


# ----------------------------------------------------------------------------
# per-layer init / apply
# ----------------------------------------------------------------------------
def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec):
    if spec.moe:
        raise NotImplementedError(_MOE_QUEUED)
    dt = cfg.param_dtype
    p = {"norm1": torch.zeros((cfg.d_model,), dtype=dt)}
    if spec.kind == "attn":
        p["mixer"] = L.init_attention(gen, cfg)
    else:
        p["mixer"] = init_mamba(gen, cfg)
    if cfg.d_ff > 0:
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dt)
        p["ffn"] = L.init_mlp(gen, cfg)
    return p


def apply_layer(p, x, cfg: ModelConfig, spec: LayerSpec, *,
                attn_chunk: int = 1024, impl: str = "xla"):
    """One pre-norm residual layer on x [K, B, S, D]."""
    if spec.moe:
        raise NotImplementedError(_MOE_QUEUED)
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.kind == "attn":
        h = L.attention_fwd(p["mixer"], h, cfg, window=spec.window,
                            chunk=attn_chunk, impl=impl)
    else:
        h = mamba_fwd(p["mixer"], h, cfg, impl=impl)
    x = x + h
    if "ffn" in p:
        x = x + L.mlp(p["ffn"], L.rms_norm(x, p["norm2"], cfg.norm_eps))
    return x


# ----------------------------------------------------------------------------
# whole stack
# ----------------------------------------------------------------------------
def backbone(params, x, cfg: ModelConfig, *, attn_chunk: int = 1024,
             remat: bool = False, impl: str = "xla"):
    """x: [K, B, S, D] embeddings -> hidden [K, B, S, D] after the final
    norm.  ``params["blocks"]`` leaves are [K, n_blocks, ...].  ``remat``:
    activation-checkpoint each super-block.  ``impl="pallas"``: route the
    attention/SSD mixers through the kernels (differentiable — the
    backward recomputes through the plain path)."""
    pattern = cfg.block_pattern()

    def blk(h, bp):
        for i, spec in enumerate(pattern):
            h = apply_layer(bp[f"l{i}"], h, cfg, spec, attn_chunk=attn_chunk,
                            impl=impl)
        return h

    for n in range(cfg.n_blocks):
        bp = tree_map(lambda t: t[:, n], params["blocks"])
        # no torch random bits in a block (dropout is a counter hash), so
        # no RNG state is stashed: a CUDA graph can capture the recompute
        x = (checkpoint(blk, x, bp, use_reentrant=False,
                        preserve_rng_state=False) if remat
             else blk(x, bp))
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)
