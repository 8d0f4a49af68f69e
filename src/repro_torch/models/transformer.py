"""The layer stack: ``n_blocks`` repetitions of the config's super-block
(``ModelConfig.block_pattern``), for the FL encoders and for the
decoder-only LM with its serving path (bulk prefill, cached decode).

Two layouts of the same blocks:

* the FL encoders' per-client stacks: leaves [K, n_blocks, ...] and
  activations [K, B, S, D] (``backbone``);
* the LM's params with no cohort axis (``blocks`` leaves [n_blocks, ...],
  as in the JAX package) and tokens [B, S].  The LM functions call the same
  blocks on K=1 views (``k1``: ``unsqueeze(0)``, no copy), with activations
  [1, B, S, D]; ``_project_qkv``'s [K·B, S, KH, hd] is then the decode
  cache's [B, S, KH, hd].

The JAX package scans the blocks with ``lax.scan``; here Python loops over
them.  With ``remat`` each block runs under non-reentrant
``torch.utils.checkpoint``: its activations are recomputed in the backward
(and a kernel-path block launches its mixer kernel again there).

MoE layers (``models/moe.py``) run on the LM's K=1 views: their params
carry no cohort axis, so a K>1 cohort with an MoE layer raises (no FL
encoder preset has one).  The MoE load-balance aux is summed over the
layers and carried out of ``backbone``/``forward`` into ``loss_fn``, as in
the JAX package.

The decode cache keeps the JAX package's layout, ``{l{i}: {k, v}}`` or the
Mamba2 leaves, stacked [n_blocks, B, ...], so caches compare leaf by leaf.
The serving functions write it in place (the JAX package donates it), read
no value back to the host, and take the decode position as an int or a 0-d
device tensor, so a decode step can be captured as one CUDA graph
(``launch/serve.py``, ``launch/continuous.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import dtensor_layouts as DL
from ..core.trees import tree_map
from ..device import resolve_device
from . import layers as L
from .config import LayerSpec, ModelConfig
from .mamba2 import (init_mamba, init_mamba_cache, mamba_decode, mamba_fwd,
                     mamba_prefill)
from .moe import init_moe, moe_apply


def k1(tree):
    """A tree with no cohort axis as K=1 views (``unsqueeze(0)``)."""
    return tree_map(lambda t: t.unsqueeze(0), tree)


# ----------------------------------------------------------------------------
# per-layer init / apply
# ----------------------------------------------------------------------------
def init_layer(gen: Optional[torch.Generator], cfg: ModelConfig,
               spec: LayerSpec):
    dt, dev = cfg.param_dtype, L.gen_device(gen)
    p = {"norm1": torch.zeros((cfg.d_model,), dtype=dt, device=dev)}
    if spec.kind == "attn":
        p["mixer"] = L.init_attention(gen, cfg)
    else:
        p["mixer"] = init_mamba(gen, cfg)
    if spec.moe:
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dt, device=dev)
        p["ffn"] = init_moe(gen, cfg)
    elif cfg.d_ff > 0:
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dt, device=dev)
        p["ffn"] = L.init_mlp(gen, cfg)
    return p


def _ffn(p, x, cfg: ModelConfig, spec: LayerSpec, n_groups: int):
    """The FFN half of a layer on x [K, B, S, D]: returns (x, MoE aux, or
    None without an MoE FFN)."""
    aux = None
    if "ffn" not in p:
        return x, aux
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    if spec.moe:
        if x.shape[0] != 1:
            raise NotImplementedError(
                "MoE layers run on the LM's K=1 views; no FL encoder "
                "preset has one")
        h, aux = moe_apply(tree_map(lambda t: t[0], p["ffn"]), h[0], cfg,
                           n_groups=n_groups)
        h = h[None]
    else:
        h = L.mlp(p["ffn"], h)
    return x + h, aux


def apply_layer(p, x, cfg: ModelConfig, spec: LayerSpec, *,
                n_groups: int = 1, attn_chunk: int = 1024,
                impl: str = "xla"):
    """One pre-norm residual layer on x [K, B, S, D]: returns (x, MoE
    aux, or None without an MoE FFN)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.kind == "attn":
        h = L.attention_fwd(p["mixer"], h, cfg, window=spec.window,
                            chunk=attn_chunk, impl=impl)
    else:
        h = mamba_fwd(p["mixer"], h, cfg, impl=impl)
    return _ffn(p, x + h, cfg, spec, n_groups)


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, seq: int,
                     dtype, device=None):
    if spec.kind == "attn":
        return L.init_attn_cache(cfg, batch, seq, spec.window, dtype, device)
    return init_mamba_cache(cfg, batch, dtype, device)


def apply_layer_prefill(p, x, cache, cfg: ModelConfig, spec: LayerSpec, *,
                        n_groups: int = 1, attn_chunk: int = 1024,
                        impl: str = "pallas"):
    """The training forward of one layer over the whole prompt
    (x [K, B, S, D]) that also fills this layer's decode cache (leaves
    [K·B, ...]) in place — attention: the K/V at their ring slots; Mamba2:
    the conv tails and the final SSD state.  ``impl="pallas"`` runs the
    mixer's contraction through its kernel (flash attention, the SSD chunk
    scan), ``"xla"`` through the plain path.  An MoE FFN routes in
    ``n_groups`` groups, as in training."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.kind == "attn":
        h, k, v = L.attention_prefill(p["mixer"], h, cfg, window=spec.window,
                                      chunk=attn_chunk, impl=impl)
        L.fill_attn_cache(cache, k, v, seq_len=x.shape[2])
    else:
        h, newc = mamba_prefill(p["mixer"], h, cfg, impl=impl)
        for name, t in newc.items():
            cache[name].copy_(t)
    return _ffn(p, x + h, cfg, spec, n_groups)[0], cache


def apply_layer_decode(p, x, cache, index, cfg: ModelConfig,
                       spec: LayerSpec):
    """One layer on one new token x [K, B, 1, D] against its cache (an MoE
    FFN routes the batch's B tokens as one group)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.kind == "attn":
        h, cache = L.attention_decode(p["mixer"], h, cache, index, cfg,
                                      window=spec.window)
    else:
        h, cache = mamba_decode(p["mixer"], h, cache, cfg)
    return _ffn(p, x + h, cfg, spec, 1)[0], cache


# ----------------------------------------------------------------------------
# whole stack (per-client stacks)
# ----------------------------------------------------------------------------
def backbone(params, x, cfg: ModelConfig, *, n_groups: int = 1,
             attn_chunk: int = 1024, residual_spec=None, remat: bool = False,
             impl: str = "xla"):
    """x: [K, B, S, D] embeddings -> (hidden [K, B, S, D] after the final
    norm, MoE aux summed over the layers).  ``params["blocks"]`` leaves are
    [K, n_blocks, ...].  ``residual_spec``: the DTensor placements of the
    [K, B, S, D] stream, set on entry and after every super-block
    (``dtensor_layouts.constrain``; the dry run's batch-over-data stream,
    or its ``residual=seq_model`` lever's sequence-over-model one); a
    plain stream is left as it is.  ``remat``: activation-checkpoint each
    super-block.
    ``impl="pallas"``: route the attention/SSD mixers through the kernels
    (differentiable — the backward recomputes through the plain path)."""
    pattern = cfg.block_pattern()

    def add(aux, a):
        return a if aux is None else aux if a is None else aux + a

    def blk(h, bp):
        aux = None
        for i, spec in enumerate(pattern):
            h, a = apply_layer(bp[f"l{i}"], h, cfg, spec, n_groups=n_groups,
                               attn_chunk=attn_chunk, impl=impl)
            aux = add(aux, a)
        return DL.constrain(h, residual_spec), aux

    aux = None
    x = DL.constrain(x, residual_spec)
    for n in range(cfg.n_blocks):
        bp = tree_map(lambda t: t[:, n], params["blocks"])
        # no torch random bits in a block (dropout is a counter hash), so
        # no RNG state is stashed: a CUDA graph can capture the recompute
        x, a = (checkpoint(blk, x, bp, use_reentrant=False,
                           preserve_rng_state=False) if remat
                else blk(x, bp))
        aux = add(aux, a)
    if aux is None:             # no MoE layer: the aux loss is 0
        aux = x.new_zeros((), dtype=torch.float32)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


# ----------------------------------------------------------------------------
# the LM (params with no cohort axis)
# ----------------------------------------------------------------------------
def init_params(gen: Optional[torch.Generator], cfg: ModelConfig):
    """The LM's params on ``gen``'s device: ``blocks`` leaves stacked
    [n_blocks, ...], ``embed`` [V, D], ``final_norm``, and ``lm_head``
    [D, V] unless the embeddings are tied — the JAX package's tree."""
    pattern = cfg.block_pattern()
    dt = cfg.param_dtype
    blocks = [{f"l{i}": init_layer(gen, cfg, spec)
               for i, spec in enumerate(pattern)}
              for _ in range(cfg.n_blocks)]
    blocks = tree_map(lambda *xs: torch.stack(xs), *blocks)
    p = {
        "embed": (L.randn(gen, (cfg.vocab_size, cfg.d_model))
                  * 0.02).to(dt),
        "blocks": blocks,
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt,
                                  device=L.gen_device(gen)),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = (L.randn(gen, (cfg.d_model, cfg.vocab_size))
                        * 0.02).to(dt)
    return p


def embed_tokens(params, tokens, cfg: ModelConfig):
    return DL.lookup(params["embed"], tokens)


def unembed(params, h, cfg: ModelConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return DL.unsplit_matmul(h, w)


def lm_hidden(params, x, cfg: ModelConfig, **bk):
    """x [B, S, D] -> (hidden [B, S, D] after the final norm, MoE aux),
    through ``backbone`` on K=1 views."""
    lm = {"blocks": k1(params["blocks"]),
          "final_norm": params["final_norm"][None]}
    h, aux = backbone(lm, x[None], cfg, **bk)
    return h[0], aux


def forward(params, tokens, cfg: ModelConfig, *, n_groups: int = 1,
            attn_chunk: int = 1024, **bk):
    """tokens [B, S] -> (logits [B, S, V], moe_aux)."""
    x = embed_tokens(params, tokens, cfg)
    h, aux = lm_hidden(params, x, cfg, n_groups=n_groups,
                       attn_chunk=attn_chunk, **bk)
    return unembed(params, h, cfg), aux


def lm_loss(logits, labels, mask=None):
    """Mean next-token CE in fp32.  logits [B, S, V], labels [B, S]."""
    lg = logits.float()
    nll = DL.logsumexp(lg) - DL.gold_logit(lg, labels)
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def chunked_lm_loss(params, h, labels, cfg: ModelConfig, chunk: int):
    """Unembedding + CE over sequence chunks: only [B, chunk, V] logits
    exist at a time."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    tot = h.new_zeros((), dtype=torch.float32)
    for t0 in range(0, S, chunk):
        lg = unembed(params, h[:, t0:t0 + chunk], cfg).float()
        gold = DL.gold_logit(lg, labels[:, t0:t0 + chunk])
        tot = tot + (DL.logsumexp(lg) - gold).sum()
    return tot / (B * S)


def loss_fn(params, batch, cfg: ModelConfig, *, n_groups: int = 1,
            attn_chunk: int = 1024, aux_weight: float = 0.01,
            loss_chunk: Optional[int] = None, **bk):
    if loss_chunk:
        x = embed_tokens(params, batch["tokens"], cfg)
        h, aux = lm_hidden(params, x, cfg, n_groups=n_groups,
                           attn_chunk=attn_chunk, **bk)
        return (chunked_lm_loss(params, h, batch["labels"], cfg, loss_chunk)
                + aux_weight * aux)
    logits, aux = forward(params, batch["tokens"], cfg, n_groups=n_groups,
                          attn_chunk=attn_chunk, **bk)
    return lm_loss(logits, batch["labels"], batch.get("mask")) \
        + aux_weight * aux


# ----------------------------------------------------------------------------
# serving: prefill + decode
# ----------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None,
               device="cuda"):
    """The decode cache, zeros: ``{l{i}: leaves [n_blocks, B, ...]}``."""
    dtype = dtype or cfg.param_dtype
    dev = resolve_device(device)
    single = {f"l{i}": init_layer_cache(cfg, spec, batch, seq, dtype, dev)
              for i, spec in enumerate(cfg.block_pattern())}
    return tree_map(lambda a: a.new_zeros((cfg.n_blocks, *a.shape)), single)


def _layer(params, cache, n: int, i: int):
    """Layer i of block n: its params as K=1 views and its cache views."""
    return (k1(tree_map(lambda t: t[n], params["blocks"][f"l{i}"])),
            tree_map(lambda t: t[n], cache[f"l{i}"]))


@torch.no_grad()
def decode_step(params, cache, token, index, cfg: ModelConfig):
    """token [B, 1] ints; index: #tokens already cached (an int or a 0-d
    device tensor).  Returns (logits [B, 1, V], cache), the cache written
    in place."""
    pattern = cfg.block_pattern()
    x = embed_tokens(params, token, cfg)[None]                # [1, B, 1, D]
    index = L.as_index(index, x.device)
    for n in range(cfg.n_blocks):
        for i, spec in enumerate(pattern):
            bp, bc = _layer(params, cache, n, i)
            x, _ = apply_layer_decode(bp, x, bc, index, cfg, spec)
    h = L.rms_norm(x, params["final_norm"][None], cfg.norm_eps)[0]
    return unembed(params, h, cfg), cache


@torch.no_grad()
def prefill(params, tokens, cfg: ModelConfig, *, n_groups: int = 1,
            attn_chunk: int = 1024, **bk):
    """Prefill forward: the LAST position's logits [B, V] (no cache)."""
    h, _ = lm_hidden(params, embed_tokens(params, tokens, cfg), cfg,
                     n_groups=n_groups, attn_chunk=attn_chunk, **bk)
    return unembed(params, h[:, -1:, :], cfg)[:, 0, :]


@torch.no_grad()
def prefill_with_cache(params, tokens, cache, cfg: ModelConfig, *,
                       n_groups: int = 1, attn_chunk: int = 1024,
                       impl: str = "pallas"):
    """Bulk prefill: one pass over the prompt that fills the decode cache
    and returns the last position's logits.

    tokens [B, S]; ``cache`` from ``init_cache``.  Returns (logits [B, V],
    cache) — the cache filled in place and ready for
    ``decode_step(..., index=S)``, replacing S teacher-forced decode
    steps.  ``impl="pallas"`` (the default) runs every attention and SSD
    contraction through its kernel on a card; ``"xla"`` the plain path."""
    pattern = cfg.block_pattern()
    x = embed_tokens(params, tokens, cfg)[None]               # [1, B, S, D]
    for n in range(cfg.n_blocks):
        for i, spec in enumerate(pattern):
            bp, bc = _layer(params, cache, n, i)
            x, _ = apply_layer_prefill(bp, x, bc, cfg, spec,
                                       n_groups=n_groups,
                                       attn_chunk=attn_chunk, impl=impl)
    h = L.rms_norm(x[:, :, -1:], params["final_norm"][None],
                   cfg.norm_eps)[0]
    return unembed(params, h, cfg)[:, 0, :], cache
