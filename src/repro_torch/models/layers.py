"""Transformer building blocks on per-client stacks: RMSNorm, RoPE, GQA
attention, SwiGLU MLP.

Every parameter leaf carries a leading cohort axis K and every activation
is [K, B, ...]: projections are batched products over K (``kmm``), stored
``[d_in, d_out]`` and applied as ``x @ w`` as in the JAX package, so
parameter trees cross between the packages without a reshuffle.  The
attention contraction carries no weights, so it flattens K·B into one batch
axis.

``chunked_attention`` is the plain path (query chunks, online softmax in
f32, never the S×S matrix across chunks; causal, sliding-window or
bidirectional); ``pallas_attention`` keeps the JAX package's name for the
kernel path: the hand-written flash-attention kernel
(``kernels/flash_attention``) forward, with a backward that recomputes
``chunked_attention`` — the kernel has no backward, as the TPU kernel has
none.

Decode attends one query token against a KV cache [K·B, size, KH, hd]
(a ring buffer for windowed layers), written in place at slot
``index % size``; ``fill_attn_cache`` lands a bulk prefill's K/V at the
slots S decode steps would have written.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import dtensor_layouts as DL
from ..kernels.flash_attention import ops as fa_ops
from .config import ModelConfig

NEG_INF = -1e30


# ----------------------------------------------------------------------------
# basics
# ----------------------------------------------------------------------------
def per_client(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-client [K, ..., d] leaf viewed to broadcast against an
    activation [K, B, ..., d] of more axes."""
    return v.reshape(v.shape[0], *([1] * (x.dim() - v.dim())),
                     *v.shape[1:])


def promote(x: torch.Tensor, w: torch.Tensor):
    """(x, w) in their common type, as ``jnp`` promotes a product: a
    bfloat16 weight meeting a float32 stream computes in float32 (torch
    refuses a mixed product)."""
    if x.dtype == w.dtype:
        return x, w
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def kmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [K, ..., d_in] @ w [K, d_in, d_out] -> [K, ..., d_out], in the
    operands' common type (``promote``); DTensors laid out by
    ``dtensor_layouts.matmul_operands``."""
    x, w = promote(x, w)
    x, w = DL.matmul_operands(x, w)
    K = x.shape[0]
    y = torch.bmm(x.reshape(K, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the ``1 + scale`` form (zero-initialised scales), f32
    inside; ``scale`` is per client [K, d]."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (1.0 + per_client(scale, x).float())
    return y.to(x.dtype)


def randn(gen: Optional[torch.Generator], shape) -> torch.Tensor:
    """Standard normal draws from ``gen`` on the generator's device.
    ``gen=None`` draws nothing: an uninitialised tensor on the default
    device, for shapes under ``torch.device("meta")``
    (``launch.steps.params_shape``)."""
    if gen is None:
        return torch.empty(shape)
    return torch.randn(shape, generator=gen, device=gen.device)


def gen_device(gen: Optional[torch.Generator]):
    """Where a generator's params go (None: the default device)."""
    return None if gen is None else gen.device


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               bias: bool = False):
    p = {"w": (randn(gen, (d_in, d_out)) / math.sqrt(d_in)).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen_device(gen))
    return p


def dense(p, x):
    """x @ w (+ b) per client: ``p["w"]`` [K, d_in, d_out], optional
    ``p["b"]`` [K, d_out].  A DTensor product that is a partial sum (the
    contraction split over ranks) is reduced, scattered over the batch
    where it divides, and pinned, so its gradient comes back reduced."""
    y = DL.pin(DL.reduce_partial(kmm(x, p["w"]), 1))
    if "b" in p:
        y = y + per_client(p["b"], y)
    return y


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------
def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split RoPE.  x: [..., S, N, hd]; positions: [S] (or any shape
    that broadcasts against x's [..., S])."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# attention parameters
# ----------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ModelConfig):
    hd, H, K, D = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    dt = cfg.param_dtype
    p = {
        "wq": init_dense(gen, D, H * hd, dt, bias=cfg.qkv_bias),
        "wk": init_dense(gen, D, K * hd, dt, bias=cfg.qkv_bias),
        "wv": init_dense(gen, D, K * hd, dt, bias=cfg.qkv_bias),
        "wo": init_dense(gen, H * hd, D, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dt, device=gen_device(gen))
        p["k_norm"] = torch.zeros((hd,), dtype=dt, device=gen_device(gen))
    return p


def _project_qkv(p, x, cfg: ModelConfig, positions):
    """x [K, B, S, D] -> q [K·B, S, H, hd], k/v [K·B, S, KH, hd]."""
    K, B, S, _ = x.shape
    hd, H, KH = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = DL.split_heads(dense(p["wq"], x), H).reshape(K, B, S, H, hd)
    k = DL.split_heads(dense(p["wk"], x), KH).reshape(K, B, S, KH, hd)
    v = DL.split_heads(dense(p["wv"], x), KH).reshape(K, B, S, KH, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return (q.reshape(K * B, S, H, hd), k.reshape(K * B, S, KH, hd),
            v.reshape(K * B, S, KH, hd))


# ----------------------------------------------------------------------------
# chunked attention (the plain path; never the S x S matrix across chunks)
# ----------------------------------------------------------------------------
def _attn_chunk(q, k, v, mask, scale):
    """q: [B,G,R,Cq,hd]  k/v: [B,G,Sk,hd]  mask: [Cq,Sk] -> [B,G,R,Cq,hd].

    G = kv head groups, R = q heads per kv head.  f32 softmax."""
    s = DL.head_product("bgrqh,bgkh->bgrqk", q, k).float() * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    z = e.sum(dim=-1, keepdim=True)
    return DL.head_product("bgrqk,bgkh->bgrqh",
                           (e / torch.clamp_min(z, 1e-30)).to(v.dtype), v)


def chunked_attention(q, k, v, *, window: Optional[int], chunk: int = 1024,
                      causal: bool = True, heads=None,
                      keep_batch: bool = False):
    """Causal (optionally sliding-window) attention, queries and keys at
    the same positions; ``causal=False`` (no window) lets every query see
    every key, as the Whisper encoder and the cross-attention do.

    q: [B, Sq, H, hd], k/v: [B, Sk, KH, hd].  Returns [B, Sq, H, hd].
    DTensors run on each rank's block (``dtensor_layouts.attend``, which
    takes ``heads`` and ``keep_batch``)."""
    return DL.attend(functools.partial(_chunked_attention, window=window,
                                       chunk=chunk, causal=causal), q, k, v,
                     heads=heads, keep_batch=keep_batch)


def _chunked_attention(q, k, v, *, window: Optional[int], chunk: int,
                       causal: bool):
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    R = H // KH
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, Sq)
    while Sq % chunk:               # self-adjust to a divisor of Sq
        chunk //= 2
    dev = q.device

    qg = q.reshape(B, Sq, KH, R, hd).permute(0, 2, 3, 1, 4)    # [B,KH,R,Sq,hd]
    kg = k.permute(0, 2, 1, 3)                                 # [B,KH,Sk,hd]
    vg = v.permute(0, 2, 1, 3)
    outs = []
    if window is None:
        # causal: each q chunk sees keys [0, t0 + chunk); bidirectional:
        # all keys
        kpos = torch.arange(Sk, device=dev)
        for t0 in range(0, Sq, chunk):
            qpos = t0 + torch.arange(chunk, device=dev)
            mask = (kpos[None, :] <= qpos[:, None] if causal else
                    torch.ones((chunk, Sk), dtype=torch.bool, device=dev))
            outs.append(_attn_chunk(qg[:, :, :, t0:t0 + chunk], kg, vg, mask,
                                    scale))
    else:
        # sliding window: q chunk [t0, t0+chunk) sees keys
        # [t0-window+1, t0+chunk)
        w = window
        kp, vp = DL.pad_left(kg, w, 2), DL.pad_left(vg, w, 2)
        span = w + chunk
        for t0 in range(0, Sq, chunk):
            qpos = t0 + torch.arange(chunk, device=dev)
            kpos = t0 - w + torch.arange(span, device=dev)
            mask = ((kpos[None, :] <= qpos[:, None])
                    & (kpos[None, :] > qpos[:, None] - w)
                    & (kpos[None, :] >= 0))
            outs.append(_attn_chunk(qg[:, :, :, t0:t0 + chunk],
                                    kp[:, :, t0:t0 + span],
                                    vp[:, :, t0:t0 + span], mask, scale))
    out = torch.cat(outs, dim=3)                               # [B,KH,R,Sq,hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


# ----------------------------------------------------------------------------
# the kernel path: kernel forward, plain recompute backward
# ----------------------------------------------------------------------------
class _PallasAttention(torch.autograd.Function):
    """Causal attention through the flash-attention kernel; the backward
    replays ``chunked_attention`` under autograd, as the JAX custom VJP
    replays it under ``jax.vjp`` — the kernel has no backward."""

    @staticmethod
    def forward(ctx, q, k, v, window, chunk):
        ctx.window, ctx.chunk = window, chunk
        ctx.save_for_backward(q, k, v)
        return fa_ops.flash_attention(q, k, v, window=window)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            o = chunked_attention(*ins, window=ctx.window, chunk=ctx.chunk)
        return (*torch.autograd.grad(o, ins, g), None, None)


def pallas_attention(q, k, v, window: Optional[int], chunk: int):
    """Causal attention via the flash-attention kernel; layouts as
    ``chunked_attention`` (q [B,Sq,H,hd], k/v [B,Sk,KH,hd])."""
    return _PallasAttention.apply(q, k, v, window, chunk)


def attention_prefill(p, x, cfg: ModelConfig, *, window: Optional[int],
                      positions=None, chunk: int = 1024, impl: str = "xla"):
    """Attention layer that also exports the post-RoPE K/V.  x [K, B, S, D]
    -> (y [K, B, S, D], k/v [K·B, S, KH, hd]).  ``impl="pallas"`` routes the
    score/softmax/value contraction through the flash-attention kernel;
    ``"xla"`` (the JAX package's name for the plain path) through
    ``chunked_attention``."""
    K, B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    if impl == "pallas":
        o = pallas_attention(q, k, v, window, min(chunk, S))
    else:
        o = chunked_attention(q, k, v, window=window, chunk=min(chunk, S),
                              heads=DL.feature_dims(p["wq"]["w"]))
    o = DL.pin(o.reshape(K, B, S, cfg.n_heads * cfg.hd))
    return dense(p["wo"], o), k, v


def attention_fwd(p, x, cfg: ModelConfig, *, window: Optional[int],
                  positions=None, chunk: int = 1024, impl: str = "xla"):
    """Attention layer.  x: [K, B, S, D] -> [K, B, S, D]."""
    y, _, _ = attention_prefill(p, x, cfg, window=window, positions=positions,
                                chunk=chunk, impl=impl)
    return y


def fill_attn_cache(cache: dict, k, v, *, seq_len: int) -> dict:
    """Write bulk-prefill K/V [B, S, KH, hd] into a decode cache as if S
    decode steps had run: slot ``i % size`` holds position i's K/V, later
    positions overwriting earlier ones in the ring buffer — only the last
    ``min(S, size)`` positions survive, at their ring slots.  Writes the
    cache's tensors in place and returns the cache."""
    size = cache["k"].shape[1]
    S = k.shape[1]
    n = min(S, size)
    slots = torch.as_tensor(np.arange(S - n, S) % size,
                            device=cache["k"].device)
    cache["k"].index_copy_(1, slots, k[:, S - n:].to(cache["k"].dtype))
    cache["v"].index_copy_(1, slots, v[:, S - n:].to(cache["v"].dtype))
    return cache


# ----------------------------------------------------------------------------
# decode (single token vs KV cache)
# ----------------------------------------------------------------------------
def init_attn_cache(cfg: ModelConfig, batch: int, seq: int,
                    window: Optional[int], dtype, device=None) -> dict:
    size = seq if window is None else min(window, seq)
    KH, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, size, KH, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, KH, hd), dtype=dtype, device=device),
    }


def as_index(index, device) -> torch.Tensor:
    """The decode position as a 0-d int64 tensor on ``device`` (a device
    tensor passes through without a copy, so a captured step reads it)."""
    if isinstance(index, torch.Tensor) and index.device == device:
        return index.long() if index.dtype != torch.long else index
    return torch.as_tensor(int(index), dtype=torch.long, device=device)


def attention_decode(p, x, cache: dict, index, cfg: ModelConfig, *,
                     window: Optional[int]):
    """x: [K, B, 1, D]; cache k/v [K·B, size, KH, hd]; ``index`` = the
    number of tokens already cached (an int or a 0-d device tensor).

    Returns (y [K, B, 1, D], cache): the new token's K/V are written into
    the cache in place at ring slot ``index % size`` (the JAX package
    donates the cache and gets the same effect), with no read-back of
    ``index``, so the step can be captured in a CUDA graph."""
    K, B = x.shape[:2]
    hd, H, KH = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    R = H // KH
    dev = x.device
    index = as_index(index, dev)
    q, k, v = _project_qkv(p, x, cfg, index.reshape(1))
    size = cache["k"].shape[1]
    slot = torch.remainder(index, size).reshape(1)
    ck, cv = cache["k"], cache["v"]
    DL.write_slot(ck, slot, k)
    DL.write_slot(cv, slot, v)

    kpos = torch.arange(size, device=dev)
    if window is None:
        valid = kpos <= index                        # positions written so far
    else:
        # ring buffer: slot s holds absolute position p with p % size == s,
        # valid within the last ``size`` tokens (the new one included)
        abs_pos = kpos + ((index - kpos) // size) * size
        abs_pos = torch.where(abs_pos > index, abs_pos - size, abs_pos)
        valid = ((abs_pos >= 0) & (abs_pos >= index - size + 1)
                 & (abs_pos <= index))
    n = K * B
    qh = DL.split_heads(q, KH, dim=2).reshape(n, 1, KH, R, hd) \
        .permute(0, 2, 3, 1, 4)                              # [n,KH,R,1,hd]
    kh = ck.permute(0, 2, 1, 3)                              # [n,KH,size,hd]
    vh = cv.permute(0, 2, 1, 3)
    s = torch.einsum("bgrqh,bgkh->bgrqk", qh, kh).float() / math.sqrt(hd)
    s = torch.where(valid, s, NEG_INF)
    w = DL.softmax(s).to(vh.dtype)
    o = torch.einsum("bgrqk,bgkh->bgrqh", w, vh)
    o = o.permute(0, 3, 1, 2, 4).reshape(K, B, 1, H * hd)
    return dense(p["wo"], o), cache


# ----------------------------------------------------------------------------
# MLP (SwiGLU)
# ----------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None):
    d_ff = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return {
        "wg": init_dense(gen, cfg.d_model, d_ff, dt),
        "wu": init_dense(gen, cfg.d_model, d_ff, dt),
        "wd": init_dense(gen, d_ff, cfg.d_model, dt),
    }


def mlp(p, x):
    return dense(p["wd"], F.silu(dense(p["wg"], x)) * dense(p["wu"], x))
