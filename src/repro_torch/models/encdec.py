"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

The modality frontend (mel-spectrogram + conv feature extractor) is a stub,
as in the JAX package: the caller hands precomputed frame embeddings
``src_embeds`` [B, S_src, d_model].  This module is the transformer
backbone: a bidirectional encoder over frames and a causal decoder with
cross-attention, with the JAX package's parameter tree (``enc_blocks`` and
``dec_blocks`` leaves stacked [n_layers, ...]).

The layers run on K=1 views of the shared blocks (``models.layers``,
activations [1, B, S, D]).  The encoder and the cross-attention are
bidirectional and stay on the plain ``chunked_attention(causal=False)``;
the decoder's causal self-attention prefill goes through the
flash-attention kernel on a card (``impl="pallas"``).  The decode cache is
the JAX package's: ``self`` K/V [n_layers, B, seq, KH, hd] and the
encoder-side ``cross_k``/``cross_v`` [n_layers, B, S_src, KH, hd], written
in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import dtensor_layouts as DL
from ..core.trees import tree_map
from ..device import resolve_device
from . import layers as L
from .config import ModelConfig
from .transformer import k1


def init_cross_attention(gen: Optional[torch.Generator], cfg: ModelConfig):
    # same parameter structure as self-attention (wq/wk/wv/wo)
    return L.init_attention(gen, cfg)


def cross_attention_fwd(p, x, src, cfg: ModelConfig, *, chunk: int = 1024):
    """x: [K, B, Sq, D] queries; src: [K, B, Sk, D] encoder output; p with
    the cohort axis.  No RoPE, no mask."""
    K, B, Sq, _ = x.shape
    Sk = src.shape[2]
    hd, H, KH = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = DL.split_heads(L.dense(p["wq"], x), H).reshape(K, B, Sq, H, hd)
    k = DL.split_heads(L.dense(p["wk"], src), KH).reshape(K, B, Sk, KH, hd)
    v = DL.split_heads(L.dense(p["wv"], src), KH).reshape(K * B, Sk, KH,
                                                         hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    o = L.chunked_attention(q.reshape(K * B, Sq, H, hd),
                            k.reshape(K * B, Sk, KH, hd), v, window=None,
                            chunk=min(chunk, Sq), causal=False,
                            heads=DL.feature_dims(p["wq"]["w"]),
                            keep_batch=True)
    return L.dense(p["wo"], DL.pin(o.reshape(K, B, Sq, H * hd)))


def _zeros(gen, dt):
    return lambda n: torch.zeros((n,), dtype=dt, device=L.gen_device(gen))


def init_encoder_layer(gen: Optional[torch.Generator], cfg: ModelConfig):
    z = _zeros(gen, cfg.param_dtype)
    return {
        "norm1": z(cfg.d_model),
        "attn": L.init_attention(gen, cfg),
        "norm2": z(cfg.d_model),
        "mlp": L.init_mlp(gen, cfg),
    }


def init_decoder_layer(gen: Optional[torch.Generator], cfg: ModelConfig):
    z = _zeros(gen, cfg.param_dtype)
    return {
        "norm1": z(cfg.d_model),
        "self_attn": L.init_attention(gen, cfg),
        "norm_x": z(cfg.d_model),
        "cross_attn": init_cross_attention(gen, cfg),
        "norm2": z(cfg.d_model),
        "mlp": L.init_mlp(gen, cfg),
    }


def _stack(layers):
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig):
    dt = cfg.param_dtype
    D, V = cfg.d_model, cfg.vocab_size
    return {
        "enc_blocks": _stack([init_encoder_layer(gen, cfg)
                              for _ in range(cfg.encoder_layers)]),
        "dec_blocks": _stack([init_decoder_layer(gen, cfg)
                              for _ in range(cfg.n_layers)]),
        "embed": (L.randn(gen, (V, D)) * 0.02).to(dt),
        "enc_norm": _zeros(gen, dt)(D),
        "dec_norm": _zeros(gen, dt)(D),
        "lm_head": (L.randn(gen, (D, V)) * 0.02).to(dt),
        "audio_head": {   # decision-fusion audio submodel head
            "w1": (L.randn(gen, (D, D)) * 0.02).to(dt),
            "w2": torch.zeros((D, V), dtype=dt, device=L.gen_device(gen)),
        },
    }


def _layer(blocks, i: int):
    return k1(tree_map(lambda t: t[i], blocks))


def _norm(h, scale, cfg: ModelConfig):
    return L.rms_norm(h, scale[None], cfg.norm_eps)


def encode(params, src_embeds, cfg: ModelConfig, *, attn_chunk: int = 1024):
    """src_embeds [B, S_src, D] -> encoder output [B, S_src, D], in the
    features' type promoted with the params' (float32 features under
    bfloat16 params run the encoder in float32, as in the JAX package)."""
    h = src_embeds[None]
    _, B, S, _ = h.shape
    pos = torch.arange(S, device=h.device)
    for i in range(cfg.encoder_layers):
        bp = _layer(params["enc_blocks"], i)
        a = L.rms_norm(h, bp["norm1"], cfg.norm_eps)
        q, k, v = L._project_qkv(bp["attn"], a, cfg, pos)
        a = L.chunked_attention(q, k, v, window=None,
                                chunk=min(attn_chunk, S), causal=False,
                                heads=DL.feature_dims(bp["attn"]["wq"]["w"]),
                                keep_batch=True)
        h = h + L.dense(bp["attn"]["wo"],
                        DL.pin(a.reshape(1, B, S, cfg.n_heads * cfg.hd)))
        h = h + L.mlp(bp["mlp"], L.rms_norm(h, bp["norm2"], cfg.norm_eps))
    return _norm(h, params["enc_norm"], cfg)[0]


def decode_fwd(params, tokens, enc_out, cfg: ModelConfig, *,
               attn_chunk: int = 1024, impl: str = "xla"):
    """tokens [B, S_tgt]; enc_out [B, S_src, D] -> logits [B, S_tgt, V].
    ``impl="pallas"`` runs the causal self-attention through the
    flash-attention kernel on a card (kernel forward, plain recompute
    backward); the cross-attention stays on the plain path.

    The residual stream stays in the embedding's type, and the encoder
    output enters the cross-attention in that type: a float32 ``encode``
    of float32 features under bfloat16 params would turn the stream
    float32, which the JAX package's decoder scan refuses (its carry
    keeps one type)."""
    h = DL.lookup(params["embed"], tokens)[None]
    src = enc_out[None].to(h.dtype)
    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        a = L.rms_norm(h, bp["norm1"], cfg.norm_eps)
        h = h + L.attention_fwd(bp["self_attn"], a, cfg, window=None,
                                chunk=attn_chunk, impl=impl)
        c = L.rms_norm(h, bp["norm_x"], cfg.norm_eps)
        h = h + cross_attention_fwd(bp["cross_attn"], c, src, cfg,
                                    chunk=attn_chunk)
        h = h + L.mlp(bp["mlp"], L.rms_norm(h, bp["norm2"], cfg.norm_eps))
    return _logits(params, _norm(h, params["dec_norm"], cfg)[0])


def _logits(params, h):
    """h [.., D] @ lm_head [D, V], partitioned as XLA partitions a product
    whose 51865-word vocab no model split divides
    (``dtensor_layouts.unsplit_matmul``)."""
    return DL.unsplit_matmul(h, params["lm_head"])


def audio_head_logits(params, enc_out):
    """Decision-fusion audio submodel: pooled encoder -> vocab logits
    [B, V]."""
    pooled = enc_out.mean(dim=1)
    h = F.gelu(torch.matmul(*DL.matmul_operands(
        *L.promote(pooled, params["audio_head"]["w1"]))), approximate="tanh")
    return torch.matmul(*L.promote(h, params["audio_head"]["w2"]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def init_dec_cache(cfg: ModelConfig, batch: int, seq: int, src_len: int,
                   dtype=None, device="cuda"):
    dtype = dtype or cfg.param_dtype
    dev = resolve_device(device)
    KH, hd, nL = cfg.n_kv_heads, cfg.hd, cfg.n_layers

    def z(s):
        return torch.zeros((nL, batch, s, KH, hd), dtype=dtype, device=dev)
    # the cross-attention K/V are computed once from the encoder output
    return {"self": {"k": z(seq), "v": z(seq)},
            "cross_k": z(src_len), "cross_v": z(src_len)}


@torch.no_grad()
def cross_kv(params, enc_out, cfg: ModelConfig):
    """All decoder layers' cross-attention K/V in one stacked einsum over
    the layer axis.  enc_out [B, S_src, D] -> (k, v), each
    [n_layers, B, S_src, KH, hd] (``init_dec_cache``'s ``cross_k``/
    ``cross_v``): a plain dense per layer, plus the qkv bias where the
    config has one, no qk_norm — ``decode_step``'s cached-K path."""
    B, Ssrc, _ = enc_out.shape
    nL, KH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    ca = params["dec_blocks"]["cross_attn"]

    def proj(wp):
        y = torch.einsum("bsd,ldo->lbso", enc_out, wp["w"])
        if "b" in wp:
            y = y + wp["b"][:, None, None, :]
        return DL.split_heads(y, KH).reshape(nL, B, Ssrc, KH, hd)

    return proj(ca["wk"]), proj(ca["wv"])


@torch.no_grad()
def prefill_with_cache(params, tokens, enc_out, cache, cfg: ModelConfig, *,
                       attn_chunk: int = 1024, impl: str = "pallas"):
    """Bulk decoder prefill: fill the self-attention cache in one pass and
    return the last position's logits.

    tokens [B, S]; ``cache`` from ``init_dec_cache`` with ``cross_k``/
    ``cross_v`` filled (``cross_kv``).  Returns (logits [B, V], cache)
    ready for ``decode_step(..., index=S)``.  ``impl="pallas"`` runs the
    causal self-attention through the flash-attention kernel on a card."""
    h = DL.lookup(params["embed"], tokens)[None]
    S = h.shape[2]
    src = enc_out[None]
    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        a = L.rms_norm(h, bp["norm1"], cfg.norm_eps)
        a, k, v = L.attention_prefill(bp["self_attn"], a, cfg, window=None,
                                      chunk=attn_chunk, impl=impl)
        L.fill_attn_cache(tree_map(lambda t: t[i], cache["self"]), k, v,
                          seq_len=S)
        h = h + a
        c = L.rms_norm(h, bp["norm_x"], cfg.norm_eps)
        h = h + cross_attention_fwd(bp["cross_attn"], c, src, cfg,
                                    chunk=attn_chunk)
        h = h + L.mlp(bp["mlp"], L.rms_norm(h, bp["norm2"], cfg.norm_eps))
    return _logits(params, _norm(h[:, :, -1], params["dec_norm"], cfg)[0]), \
        cache


@torch.no_grad()
def decode_step(params, cache, token, index, cfg: ModelConfig):
    """One decoder token against the self cache and the precomputed cross
    K/V.  Returns (logits [B, 1, V], cache), the self cache written in
    place."""
    x = DL.lookup(params["embed"], token)[None]                # [1, B, 1, D]
    hd, H, KH = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    R = H // KH
    B = x.shape[1]
    index = L.as_index(index, x.device)
    h = x
    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        a = L.rms_norm(h, bp["norm1"], cfg.norm_eps)
        a, _ = L.attention_decode(bp["self_attn"], a,
                                  tree_map(lambda t: t[i], cache["self"]),
                                  index, cfg, window=None)
        h = h + a
        # cross attention against the precomputed K/V (no mask)
        c = L.rms_norm(h, bp["norm_x"], cfg.norm_eps)
        q = DL.split_heads(L.dense(bp["cross_attn"]["wq"], c), KH) \
            .reshape(B, 1, KH, R, hd)
        qh = q.permute(0, 2, 3, 1, 4)
        kh = cache["cross_k"][i].permute(0, 2, 1, 3)
        vh = cache["cross_v"][i].permute(0, 2, 1, 3)
        s = torch.einsum("bgrqh,bgkh->bgrqk", qh, kh).float() / math.sqrt(hd)
        w = torch.softmax(s, dim=-1).to(vh.dtype)
        o = torch.einsum("bgrqk,bgkh->bgrqh", w, vh)
        o = o.permute(0, 3, 1, 2, 4).reshape(1, B, 1, H * hd)
        h = h + L.dense(bp["cross_attn"]["wo"], o)
        h = h + L.mlp(bp["mlp"], L.rms_norm(h, bp["norm2"], cfg.norm_eps))
    return _logits(params, _norm(h, params["dec_norm"], cfg)[0]), cache
