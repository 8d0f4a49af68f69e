"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) on per-client
stacks.

Train/prefill uses the chunked SSD algorithm: an intra-chunk attention-like
contraction plus an inter-chunk recurrence over the chunk states.
``ssd_chunked`` is the plain path; ``ssd_pallas`` keeps the JAX package's
name for the kernel path: the hand-written SSD intra-chunk kernel
(``kernels/ssd_scan``) forward, with a backward that recomputes
``ssd_chunked`` — the kernel has no backward, as the TPU kernel has none.

Parameters carry a leading cohort axis K (``wz`` [K, D, d_inner], ...),
with the JAX package's leaf names; the z/x/B/C/dt projections stay separate
arrays, as there.  The SSD contraction carries no weights, so it flattens
K·B into one batch axis, with the per-client ``A`` repeated per row.

Decode keeps a constant-size cache — the depthwise conv's last taps-1 raw
inputs and the SSM state [K·B, nh, N, hp] — written in place;
``mamba_prefill`` exports the state S decode steps would reach.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .. import dtensor_layouts as DL
from ..kernels.ssd_scan import ops as ssd_ops
from .config import ModelConfig
from .layers import dense, gen_device, kmm, per_client, randn, rms_norm


def init_mamba(gen: torch.Generator, cfg: ModelConfig):
    D, di, N, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    dt = cfg.param_dtype
    dev = gen_device(gen)

    def proj(d_in, d_out):
        return (randn(gen, (d_in, d_out)) / math.sqrt(d_in)).to(dt)

    def shift(n):                   # identity conv: the last tap is 1
        w = torch.zeros((cfg.ssm_conv, n), dtype=dt, device=dev)
        w[-1] = 1.0
        return w

    return {
        "wz": proj(D, di),
        "wx": proj(D, di),
        "wB": proj(D, N),
        "wC": proj(D, N),
        "wdt": proj(D, nh),
        "conv_x": (randn(gen, (cfg.ssm_conv, di)) * 0.1).to(dt),
        "conv_B": shift(N),
        "conv_C": shift(N),
        "conv_bx": torch.zeros((di,), dtype=dt, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "norm": torch.zeros((di,), dtype=dt, device=dev),
        "out_proj": proj(di, D),
    }


def _causal_conv(x, w, b=None):
    """Depthwise causal conv over S with a left zero pad, then silu.
    x: [K, B, S, C], w: [K, taps, C], b: [K, C]."""
    taps, S = w.shape[1], x.shape[2]
    xp = DL.pad_left(x, taps - 1, 2)
    out = sum(xp[:, :, i:i + S, :] * w[:, None, None, i, :]
              for i in range(taps))
    if b is not None:
        out = out + per_client(b, out)
    return F.silu(out)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, return_state: bool = False,
                heads=None):
    """Chunked SSD, the plain path; DTensors run on each rank's heads
    (``dtensor_layouts.by_heads``, which takes ``heads``).

    x:  [B, S, nh, hp]   (conv'd + silu'd input)
    dt: [B, S, nh]       (post-softplus step sizes, fp32)
    A:  [nh] or per batch row [B, nh] (negative, fp32)
    Bm: [B, S, N], Cm: [B, S, N]
    Returns y: [B, S, nh, hp] in x's type; with ``return_state`` also the
    final recurrent state h_S [B, nh, N, hp] fp32 — the inter-chunk
    recurrence's last carry, the state S sequential ``mamba_decode`` steps
    reach (the prefill's cache export).
    """
    return DL.by_heads(
        functools.partial(_ssd_chunked, chunk=chunk,
                          return_state=return_state),
        [(x, 2), (dt, 2), (A, -1), (Bm, None), (Cm, None)], out_dim=2,
        heads=heads)


def _ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, return_state: bool):
    Bsz, S, nh, hp = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"chunk {Q} does not divide S={S}")
    nc = S // Q
    xd = x.float() * dt[..., None]                                # dt-weighted
    dtA = dt * A.unsqueeze(-2)                                    # [B,S,nh]

    xc = xd.reshape(Bsz, nc, Q, nh, hp)
    dAc = dtA.reshape(Bsz, nc, Q, nh)
    Bc = Bm.float().reshape(Bsz, nc, Q, N)
    Cc = Cm.float().reshape(Bsz, nc, Q, N)

    # --- intra-chunk (diagonal blocks) ---
    cum = DL.prefix_sum(dAc, dim=2)                               # [B,nc,Q,nh]
    # decay matrix L[t,s] = exp(cum_t - cum_s), lower-triangular.  Mask the
    # EXPONENT (not the exp): upper-triangle diffs are large and positive,
    # exp overflows to inf, and 0*inf poisons the backward pass.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # [B,nc,Q,Q,nh]
    tri = torch.ones((Q, Q), dtype=torch.bool,
                     device=x.device).tril()[None, None, :, :, None]
    Lmat = torch.exp(torch.where(tri, diff, -torch.inf))
    scores = DL.shared_product("bctn,bcsn->bcts", Cc, Bc)         # [B,nc,Q,Q]
    y_diag = torch.einsum("bctsh,bcts,bcshp->bcthp", Lmat, scores, xc)

    # --- chunk summary states: S_c = Σ_s exp(cum_last − cum_s) B_s x_s^T ---
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)             # [B,nc,Q,nh]
    states = torch.einsum("bcsn,bcsh,bcshp->bchnp", Bc, decay_to_end, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                     # [B,nc,nh]

    # --- inter-chunk recurrence ---
    h = x.new_zeros((Bsz, nh, N, hp), dtype=torch.float32)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                           # [B,nc,nh,N,hp]

    # --- inter-chunk contribution: y_off[t] = C_t · (exp(cum_t) * h_prev) ---
    in_decay = torch.exp(cum)                                     # [B,nc,Q,nh]
    y_off = torch.einsum("bctn,bcth,bchnp->bcthp", Cc, in_decay, h_prev)
    y = (y_diag + y_off).reshape(Bsz, S, nh, hp).to(x.dtype)
    return (y, h) if return_state else y


class _SSDPallas(torch.autograd.Function):
    """Chunked SSD through the intra-chunk kernel; the backward replays
    ``ssd_chunked`` under autograd, as the JAX custom VJP replays it under
    ``jax.vjp`` — the kernel has no backward."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return ssd_ops.ssd_forward(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ssd_chunked(*ins, ctx.chunk)
        return (*torch.autograd.grad(y, ins, g), None)


def ssd_pallas(x, dt, A, Bm, Cm, chunk: int):
    """Same contract as ``ssd_chunked``, through the kernel."""
    return _SSDPallas.apply(x, dt, A, Bm, Cm, chunk)


def mamba_fwd(p, u, cfg: ModelConfig, *, impl: str = "xla"):
    """u: [K, B, S, D] -> [K, B, S, D].  ``impl="pallas"`` routes the
    chunked-SSD contraction through the kernel (``ssd_pallas``), ``"xla"``
    (the JAX package's name for the plain path) through ``ssd_chunked``."""
    K, B, S, D = u.shape
    nh, hp = cfg.ssm_n_heads, cfg.ssm_head_dim
    z = kmm(u, p["wz"])
    x = _causal_conv(kmm(u, p["wx"]), p["conv_x"], p["conv_bx"])
    Bm = _causal_conv(kmm(u, p["wB"]), p["conv_B"])
    Cm = _causal_conv(kmm(u, p["wC"]), p["conv_C"])
    a = kmm(u, p["wdt"]).float() + per_client(p["dt_bias"], u)
    dt = torch.logaddexp(a, torch.zeros_like(a))                  # softplus
    A = -torch.exp(p["A_log"])                                    # [K, nh]
    xh = x.reshape(K * B, S, nh, hp)
    ssd = ssd_pallas if impl == "pallas" else ssd_chunked
    kw = {} if impl == "pallas" else {"heads": DL.feature_dims(p["wx"])}
    y = ssd(xh, dt.reshape(K * B, S, nh), A.repeat_interleave(B, dim=0),
            Bm.reshape(K * B, S, -1), Cm.reshape(K * B, S, -1),
            cfg.ssm_chunk, **kw)
    y = (y + xh * p["D"].repeat_interleave(B, dim=0)[:, None, :, None]
         .to(x.dtype))
    y = y.reshape(K, B, S, cfg.d_inner)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return _out_proj(p, y)


def _out_proj(p, y):
    """The output projection, as ``dense``: on DTensors its partial sum
    over the ranks that split d_inner is reduced, so the next layer's
    projections (jamba's mamba layers after an MoE one) meet a reduced
    stream, not 16 ranks' partial ones."""
    return dense({"w": p["out_proj"]}, y)


# ----------------------------------------------------------------------------
# decode: a constant-size cache of conv tails and the SSM state
# ----------------------------------------------------------------------------
def init_mamba_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> dict:
    taps = cfg.ssm_conv
    return {
        "conv_x": torch.zeros((batch, taps - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, taps - 1, cfg.ssm_state), dtype=dtype,
                              device=device),
        "conv_C": torch.zeros((batch, taps - 1, cfg.ssm_state), dtype=dtype,
                              device=device),
        "ssm": torch.zeros((batch, cfg.ssm_n_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
    }


def _conv_step(tail, new, w, b=None):
    """tail: [K, B, taps-1, C]; new: [K, B, C]; w: [K, taps, C] ->
    (silu'd out [K, B, C], new tail [K, B, taps-1, C])."""
    window = torch.cat([tail, new[:, :, None, :].to(tail.dtype)], dim=2)
    out = torch.einsum("zbkc,zkc->zbc", window, w)
    if b is not None:
        out = out + per_client(b, out)
    return F.silu(out), window[:, :, 1:, :]


def mamba_decode(p, u, cache: dict, cfg: ModelConfig):
    """u: [K, B, 1, D]; cache leaves [K·B, ...] -> (y [K, B, 1, D], cache),
    the conv tails and the state written into the cache in place."""
    K, B = u.shape[:2]
    nh, hp = cfg.ssm_n_heads, cfg.ssm_head_dim
    u0 = u[:, :, 0]                                               # [K,B,D]

    def tail(name):
        t = cache[name]
        return t.reshape(K, B, *t.shape[1:])

    z = kmm(u0, p["wz"])
    x, tx = _conv_step(tail("conv_x"), kmm(u0, p["wx"]), p["conv_x"],
                       p["conv_bx"])
    Bm, tB = _conv_step(tail("conv_B"), kmm(u0, p["wB"]), p["conv_B"])
    Cm, tC = _conv_step(tail("conv_C"), kmm(u0, p["wC"]), p["conv_C"])
    a = kmm(u0, p["wdt"]).float() + per_client(p["dt_bias"], u0)
    dt = torch.logaddexp(a, torch.zeros_like(a))                  # [K,B,nh]
    A = -torch.exp(p["A_log"])                                    # [K,nh]
    dec = torch.exp(dt * A[:, None, :])
    xh = x.reshape(K, B, nh, hp).float()
    h = tail("ssm") * dec[..., None, None] + torch.einsum(
        "zbn,zbhp->zbhnp", Bm.float(), xh * dt[..., None])
    y = torch.einsum("zbn,zbhnp->zbhp", Cm.float(), h)
    y = y + xh * p["D"][:, None, :, None]
    y = y.reshape(K, B, cfg.d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    for name, new in (("conv_x", tx), ("conv_B", tB), ("conv_C", tC),
                      ("ssm", h)):
        cache[name].copy_(new.reshape(cache[name].shape))
    return _out_proj(p, y)[:, :, None, :], cache


def _conv_tail(raw, taps: int):
    """The last taps-1 raw (pre-activation) projections [K, B, S, C] ->
    [K, B, taps-1, C], zero-padded on the left when S < taps-1 — the
    implicit zero history of ``_causal_conv`` and the zeros of
    ``init_mamba_cache``."""
    S = raw.shape[2]
    t = raw[:, :, max(S - (taps - 1), 0):, :]
    pad = (taps - 1) - t.shape[2]
    return DL.pad_left(t, pad, 2) if pad else t


def mamba_prefill(p, u, cfg: ModelConfig, *, impl: str = "pallas"):
    """Bulk prefill: the chunked-SSD forward plus a decode-cache export.

    u: [K, B, S, D] -> (y [K, B, S, D], cache with leaves [K·B, ...]),
    ``cache`` exactly the state S sequential ``mamba_decode`` steps leave
    behind: the conv tails hold the last ``ssm_conv - 1`` raw projections
    and ``ssm`` is the chunked scan's final fp32 state.  ``impl="pallas"``
    runs the SSD contraction through ``kernels/ssd_scan.ssd_forward`` (the
    kernel on a CUDA tensor), ``"xla"`` through ``ssd_chunked``."""
    K, B, S, D = u.shape
    nh, hp = cfg.ssm_n_heads, cfg.ssm_head_dim
    z = kmm(u, p["wz"])
    xr, Br, Cr = kmm(u, p["wx"]), kmm(u, p["wB"]), kmm(u, p["wC"])
    x = _causal_conv(xr, p["conv_x"], p["conv_bx"])
    Bm = _causal_conv(Br, p["conv_B"])
    Cm = _causal_conv(Cr, p["conv_C"])
    a = kmm(u, p["wdt"]).float() + per_client(p["dt_bias"], u)
    dt = torch.logaddexp(a, torch.zeros_like(a))
    A = -torch.exp(p["A_log"])
    xh = x.reshape(K * B, S, nh, hp)
    Q = min(cfg.ssm_chunk, S)
    while S % Q:                   # self-adjust to a divisor of S
        Q //= 2
    ssd = ssd_ops.ssd_forward if impl == "pallas" else ssd_chunked
    y, h = ssd(xh, dt.reshape(K * B, S, nh), A.repeat_interleave(B, dim=0),
               Bm.reshape(K * B, S, -1), Cm.reshape(K * B, S, -1), Q,
               return_state=True)
    y = (y + xh * p["D"].repeat_interleave(B, dim=0)[:, None, :, None]
         .to(x.dtype))
    y = y.reshape(K, B, S, cfg.d_inner)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    taps = cfg.ssm_conv
    cache = {"conv_x": _conv_tail(xr, taps), "conv_B": _conv_tail(Br, taps),
             "conv_C": _conv_tail(Cr, taps), "ssm": h}
    cache = {k: v.reshape(K * B, *v.shape[2:]) if k != "ssm" else v
             for k, v in cache.items()}
    return _out_proj(p, y), cache
