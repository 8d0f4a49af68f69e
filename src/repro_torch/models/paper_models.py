"""The paper's exact unimodal submodels (§VI "Models"), on per-client stacks.

* Audio submodel (CREMA-D & IEMOCAP): unidirectional 2-layer LSTM
  (input 11, hidden=output=50), a 50-neuron hidden FC layer, and a C-neuron
  output layer; dropout 0.1 between LSTM layers during training.
* Text submodel (IEMOCAP): same with input 100, hidden 60, 10 outputs.
* Image submodel (CREMA-D): CNN with 3 conv layers of 16 5x5 kernels
  (3x5x5, 16x5x5, 16x5x5) each followed by 5x5 max-pooling with stride 3,
  then FC hidden layers of 64 and 32 neurons and a 6-neuron output layer.

Parameters are plain ``{name: tensor}`` dicts with the JAX package's leaf
names, shapes and layouts (LSTM gates i,f,g,o in ``wi``/``wh``; CNN weights
HWIO, inputs NHWC).  Every apply function takes *per-client stacks*: each
leaf carries a leading cohort axis K and the inputs are [K, B, ...], so the
whole cohort runs batched by construction — the LSTM as ``bmm`` over K, the
CNN as a grouped convolution with ``groups=K`` — where the JAX package
vmaps one client's function.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# counter-based dropout bits
# ---------------------------------------------------------------------------
def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finaliser on int64 tensors holding uint32 values (the
    multipliers stay below 2³¹, so no product leaves int64)."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x046CA68B) & _MASK32
    return x ^ (x >> 16)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """A new stream key that depends only on (``key``, ``data``) — the
    counterpart of ``jax.random.fold_in`` (different bits, same role)."""
    return _mix32(_mix32(key) + data)


def dropout_keep(keys: torch.Tensor, n: int, shape, p: float) -> torch.Tensor:
    """Bool keep mask [K, n, *shape] with P(keep) = 1 − p.

    ``keys`` [K] are the per-client (already modality-folded) stream keys;
    sample i's mask depends only on (key, i), never on the batch size, so a
    client padded into a stacked [K, N, ...] batch draws the same masks for
    its real samples as it does standalone."""
    numel = math.prod(shape)
    dev = keys.device
    sample = fold_in(keys[:, None], torch.arange(n, device=dev)[None])
    bits = fold_in(sample[..., None],
                   torch.arange(numel, device=dev)[None, None])
    keep = bits < int(round((1.0 - p) * 2 ** 32))
    return keep.reshape((keys.shape[0], n) + tuple(shape))


# ---------------------------------------------------------------------------
# LSTM submodel
# ---------------------------------------------------------------------------
def _uniform(gen, shape, s):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * s


def _init_lstm_layer(gen, d_in, d_h):
    s = 1.0 / math.sqrt(d_h)
    return {"wi": _uniform(gen, (d_in, 4 * d_h), s),
            "wh": _uniform(gen, (d_h, 4 * d_h), s),
            "b": torch.zeros(4 * d_h)}


def init_lstm_model(gen: torch.Generator, d_in: int, d_h: int,
                    n_classes: int):
    return {
        "lstm0": _init_lstm_layer(gen, d_in, d_h),
        "lstm1": _init_lstm_layer(gen, d_h, d_h),
        "fc": {"w": torch.randn((d_h, d_h), generator=gen) / math.sqrt(d_h),
               "b": torch.zeros(d_h)},
        "out": {"w": torch.randn((d_h, n_classes), generator=gen)
                / math.sqrt(d_h),
                "b": torch.zeros(n_classes)},
    }


def _gate_acts(a):
    i, f, g, o = a.chunk(4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def _lstm_fwd_loop(wi, wh, b, x):
    """Time-major loop; the input projection x@wi is hoisted out of the loop
    as one large product.  wi [K, d_in, 4H], wh [K, H, 4H], b [K, 4H],
    x [K, B, T, d_in].  Returns (hs, pre-activations, cell states), all
    time-major [T, K, B, ...]."""
    K, B, T, _ = x.shape
    d_h = wh.shape[1]
    gx = torch.einsum("kbti,kig->tkbg", x, wi) + b[None, :, None, :]
    h = x.new_zeros(K, B, d_h)
    c = x.new_zeros(K, B, d_h)
    hs, a_s, cs = [], [], []
    for t in range(T):
        a = gx[t] + torch.bmm(h, wh)
        i, f, g, o = _gate_acts(a)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        a_s.append(a)
        cs.append(c)
    return torch.stack(hs), torch.stack(a_s), torch.stack(cs)


class LSTMScan(torch.autograd.Function):
    """One LSTM layer over a cohort, with the hand-written backward.

    Autograd through the naive loop would accumulate the [K, d_in, 4H] /
    [K, H, 4H] weight gradients step by step.  The backward here carries
    only (dh, dc) [K, B, H] through the reverse loop and stores the per-step
    gate gradients; every parameter gradient (and dx) is then one product
    after the loop — the structure of the JAX package's ``_lstm_scan_bwd``.
    """

    @staticmethod
    def forward(ctx, wi, wh, b, x):
        hs, a_s, cs = _lstm_fwd_loop(wi, wh, b, x)
        ctx.save_for_backward(wi, wh, x, hs, a_s, cs)
        return hs.permute(1, 2, 0, 3)                     # [K, B, T, H]

    @staticmethod
    def backward(ctx, dout):
        wi, wh, x, hs, a_s, cs = ctx.saved_tensors
        T, K, B, d_h = hs.shape
        dhs = dout.permute(2, 0, 1, 3)                    # [T, K, B, H]
        zero = hs.new_zeros(1, K, B, d_h)
        c_prev = torch.cat([zero, cs[:-1]])
        wh_t = wh.transpose(1, 2)
        dh_next, dc_next = zero[0], zero[0]
        das = [None] * T
        for t in reversed(range(T)):
            i, f, g, o = _gate_acts(a_s[t])
            tc = torch.tanh(cs[t])
            dh = dhs[t] + dh_next
            da_o = dh * tc * o * (1.0 - o)
            dc = dc_next + dh * o * (1.0 - tc * tc)
            da_i = dc * g * i * (1.0 - i)
            da_f = dc * c_prev[t] * f * (1.0 - f)
            da_g = dc * i * (1.0 - g * g)
            das[t] = torch.cat([da_i, da_f, da_g, da_o], dim=-1)
            dh_next, dc_next = torch.bmm(das[t], wh_t), dc * f
        das = torch.stack(das)                            # [T, K, B, 4H]
        h_prev = torch.cat([zero, hs[:-1]])
        dwi = torch.einsum("kbti,tkbg->kig", x, das)
        dwh = torch.einsum("tkbh,tkbg->khg", h_prev, das)
        db = das.sum(dim=(0, 2))
        dx = (torch.einsum("tkbg,kig->kbti", das, wi)
              if ctx.needs_input_grad[3] else None)
        return dwi, dwh, db, dx


def _lstm_layer(p, x):
    """x: [K, B, T, d_in] -> outputs [K, B, T, d_h]."""
    return LSTMScan.apply(p["wi"], p["wh"], p["b"], x)


def _dense(p, x):
    """x [K, B, d] @ w [K, d, e] + b [K, e]."""
    return torch.bmm(x, p["w"]) + p["b"][:, None, :]


def lstm_apply(p, x, *, dropout_keys: Optional[torch.Tensor] = None,
               dropout: float = 0.1):
    """x: [K, B, T, d_in] -> logits [K, B, C].  ``dropout_keys`` [K] are the
    per-client modality stream keys (``None`` = no dropout)."""
    h = _lstm_layer(p["lstm0"], x)
    if dropout_keys is not None and dropout > 0.0:
        keep = dropout_keep(dropout_keys, h.shape[1], h.shape[2:], dropout)
        h = torch.where(keep, h / (1.0 - dropout), torch.zeros_like(h))
    h = _lstm_layer(p["lstm1"], h)[:, :, -1, :]              # last hidden
    h = torch.relu(_dense(p["fc"], h))
    return _dense(p["out"], h)


# ---------------------------------------------------------------------------
# CNN submodel
# ---------------------------------------------------------------------------
def init_cnn_model(gen: torch.Generator, n_classes: int = 6, in_ch: int = 3,
                   conv_scale: float = 0.35):
    """conv_scale < He: tames activation growth through the three
    maxpool(ReLU(conv)) stages so plain BGD at the shared η is stable."""
    def conv(ci, co):
        return (torch.randn((5, 5, ci, co), generator=gen)
                * math.sqrt(2.0 / (25 * ci)) * conv_scale)

    return {
        "c0": conv(in_ch, 16),
        "c1": conv(16, 16),
        "c2": conv(16, 16),
        "fc0": {"w": torch.randn((64, 64), generator=gen) / 8.0,
                "b": torch.zeros(64)},
        "fc1": {"w": torch.randn((64, 32), generator=gen) / 8.0,
                "b": torch.zeros(32)},
        "out": {"w": torch.randn((32, n_classes), generator=gen)
                / math.sqrt(32),
                "b": torch.zeros(n_classes)},
    }


def _maxpool1d(y, dim: int, window: int, stride: int):
    """SAME 1-D max-pool along ``dim`` as a max over strided slices.

    Pads ``ph//2`` before and ``ph − ph//2`` after with −inf (asymmetric:
    (1, 2) at H=32), which ``nn.MaxPool2d`` cannot express; ``torch.maximum``
    splits the gradient of ties like ``jnp.maximum`` does."""
    H = y.shape[dim]
    out_h = -(-H // stride)
    ph = max((out_h - 1) * stride + window - H, 0)
    pad = [0, 0] * (y.ndim - 1 - dim) + [ph // 2, ph - ph // 2]
    y = F.pad(y, pad, value=float("-inf"))
    out = None
    for i in range(window):
        idx = [slice(None)] * y.ndim
        idx[dim] = slice(i, i + (out_h - 1) * stride + 1, stride)
        sl = y[tuple(idx)]
        out = sl if out is None else torch.maximum(out, sl)
    return out


def _maxpool(y, window: int = 5, stride: int = 3):
    """SAME 2-D max-pool over the H and W axes of an NCHW tensor, separated
    into two 1-D passes (H first, as the JAX package does)."""
    return _maxpool1d(_maxpool1d(y, 2, window, stride), 3, window, stride)


def _conv_pool(y, w, K: int):
    """SAME conv + ReLU + pool for K clients at once: y [N, K·C, H, W], w
    [K, kh, kw, C, O] (HWIO per client) as a grouped conv with groups=K."""
    _, kh, kw, ci, co = w.shape
    wt = w.permute(0, 4, 3, 1, 2).reshape(K * co, ci, kh, kw)
    y = F.conv2d(y, wt, padding=(kh // 2, kw // 2), groups=K)
    return _maxpool(torch.relu(y))


def cnn_apply(p, x, **_):
    """x: [K, B, 32, 32, 3] (NHWC per client) -> logits [K, B, C]."""
    K, N, H, W, C = x.shape
    y = x.permute(1, 0, 4, 2, 3).reshape(N, K * C, H, W)
    y = _conv_pool(y, p["c0"], K)       # 11x11
    y = _conv_pool(y, p["c1"], K)       # 4x4
    y = _conv_pool(y, p["c2"], K)       # 2x2
    co = p["c2"].shape[-1]
    # back to per-client NHWC order before flattening, as the JAX reshape
    y = y.reshape(N, K, co, *y.shape[2:]).permute(1, 0, 3, 4, 2)
    y = y.reshape(K, N, -1)             # 64
    y = torch.relu(_dense(p["fc0"], y))
    y = torch.relu(_dense(p["fc1"], y))
    return _dense(p["out"], y)


# ---------------------------------------------------------------------------
# dataset-level multimodal model builders
# ---------------------------------------------------------------------------
def init_crema_model(gen: torch.Generator):
    """CREMA-D: audio LSTM (11->50, 6 cls) + image CNN (32x32x3, 6 cls)."""
    return {"audio": init_lstm_model(gen, 11, 50, 6),
            "image": init_cnn_model(gen, 6)}


def init_iemocap_model(gen: torch.Generator):
    """IEMOCAP: audio LSTM (11->50, 10 cls) + text LSTM (100->60, 10 cls)."""
    return {"audio": init_lstm_model(gen, 11, 50, 10),
            "text": init_lstm_model(gen, 100, 60, 10)}


MODAL_APPLY = {"audio": lstm_apply, "text": lstm_apply, "image": cnn_apply}

#: stable per-modality dropout-stream constants: index in sorted *global*
#: modality order, as in the JAX package
MODALITY_INDEX = {m: i for i, m in enumerate(sorted(MODAL_APPLY))}


def modal_logits(params, inputs: dict, *,
                 dropout_seeds: Optional[torch.Tensor] = None,
                 dropout: float = 0.1):
    """Per-modality [K, B, C] logits for whichever modalities are present in
    ``inputs``.  ``dropout_seeds`` [K] int64 are the per-client seeds of the
    round (``None`` = no dropout)."""
    out = {}
    for m in sorted(inputs):
        keys = (None if dropout_seeds is None
                else fold_in(dropout_seeds, MODALITY_INDEX[m]))
        out[m] = MODAL_APPLY[m](params[m], inputs[m], dropout_keys=keys,
                                dropout=dropout)
    return out
