"""The paper's unimodal submodels (§VI "Models") in plain PyTorch, one
client at a time, built from the widths of a configuration file.

* LSTM submodel (audio, text): two unidirectional LSTM layers, a hidden
  FC layer with ReLU and an output layer; dropout between the two LSTM
  layers in training.
* CNN submodel (image): three SAME 5x5 convolutions, each followed by ReLU
  and a SAME max-pool (window 5, stride 3), then two hidden FC layers with
  ReLU and an output layer.

Parameters are ``{name: tensor}`` dicts with one leaf per weight, in the
layouts the paper's reference implementation publishes (LSTM gates i, f,
g, o along the last axis of ``wi``/``wh``; convolutions HWIO on NHWC
inputs).  Every op here is a plain PyTorch op with no batching over
clients and no cache.

The initialiser and the dropout bits are the experiment's conventions for
making weights and masks from a seed (``src/repro_torch/models/
paper_models.py``: ``init_*``, ``_mix32``, ``fold_in``, ``dropout_keep``),
restated here so the reference makes the same weights and masks from the
same seed without importing the program.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as F

_MASK32 = 0xFFFFFFFF
#: dropout stream constant of each modality: its index in the sorted
#: list of every modality the experiments know
STREAM_INDEX = {"audio": 0, "image": 1, "text": 2}


# ---------------------------------------------------------------------------
# seeded weights
# ---------------------------------------------------------------------------
def _uniform(gen, shape, s):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * s


def init_lstm(gen: torch.Generator, spec: Mapping, n_classes: int):
    d_in, d_h = spec["input"], spec["hidden"]
    s = 1.0 / math.sqrt(d_h)
    layers = {}
    for i in range(spec["layers"]):
        d = d_in if i == 0 else d_h
        layers[f"lstm{i}"] = {"wi": _uniform(gen, (d, 4 * d_h), s),
                              "wh": _uniform(gen, (d_h, 4 * d_h), s),
                              "b": torch.zeros(4 * d_h)}
    fc = spec["fc"]
    layers["fc"] = {"w": torch.randn((d_h, fc), generator=gen)
                    / math.sqrt(d_h), "b": torch.zeros(fc)}
    layers["out"] = {"w": torch.randn((fc, n_classes), generator=gen)
                     / math.sqrt(fc), "b": torch.zeros(n_classes)}
    return layers


def init_cnn(gen: torch.Generator, spec: Mapping, n_classes: int):
    k, f = spec["kernel"], spec["filters"]
    scale = spec["init_conv_scale"]
    p = {}
    ci = spec["channels"]
    for i in range(spec["conv_layers"]):
        p[f"c{i}"] = (torch.randn((k, k, ci, f), generator=gen)
                      * math.sqrt(2.0 / (k * k * ci)) * scale)
        ci = f
    dims = [cnn_flat_width(spec)] + list(spec["fc"])
    for i in range(len(spec["fc"])):
        p[f"fc{i}"] = {"w": torch.randn((dims[i], dims[i + 1]),
                                        generator=gen) / 8.0,
                       "b": torch.zeros(dims[i + 1])}
    p["out"] = {"w": torch.randn((dims[-1], n_classes), generator=gen)
                / math.sqrt(dims[-1]), "b": torch.zeros(n_classes)}
    return p


def init_model(config: Mapping, seed: int) -> Dict[str, dict]:
    """{modality: params} from ``seed``, modalities in the configuration's
    order (the order the weights are drawn in)."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for m, spec in config["modalities"].items():
        init = init_lstm if spec["kind"] == "lstm" else init_cnn
        out[m] = init(gen, spec, config["classes"])
    return out


# ---------------------------------------------------------------------------
# dropout bits: a counter hash of (client seed, modality, sample, element)
# ---------------------------------------------------------------------------
def _mix32(x):
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x046CA68B) & _MASK32
    return x ^ (x >> 16)


def fold_in(key, data):
    return _mix32(_mix32(key) + data)


def dropout_keep(seed: int, modality: str, n: int, shape, p: float, device):
    """Bool keep mask [n, *shape] of one client's ``n`` samples."""
    key = fold_in(torch.tensor(int(seed), dtype=torch.int64, device=device),
                  STREAM_INDEX[modality])
    sample = fold_in(key, torch.arange(n, device=device))
    bits = fold_in(sample[:, None],
                   torch.arange(math.prod(shape), device=device)[None])
    return (bits < int(round((1.0 - p) * 2 ** 32))).reshape((n,) + tuple(shape))


# ---------------------------------------------------------------------------
# forward passes of one client: x [B, ...] -> logits [B, C]
# ---------------------------------------------------------------------------
def _lstm_layer(p, x):
    """x [B, T, d] -> hidden states [B, T, H]."""
    B, T, _ = x.shape
    H = p["wh"].shape[0]
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    hs = []
    for t in range(T):
        a = x[:, t] @ p["wi"] + h @ p["wh"] + p["b"]
        i, f, g, o = a.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def lstm_forward(p, x, spec, keep=None, dropout: float = 0.0):
    h = x
    for i in range(spec["layers"]):
        h = _lstm_layer(p[f"lstm{i}"], h)
        if i == 0 and keep is not None:
            h = torch.where(keep, h / (1.0 - dropout), torch.zeros_like(h))
    h = torch.relu(h[:, -1] @ p["fc"]["w"] + p["fc"]["b"])
    return h @ p["out"]["w"] + p["out"]["b"]


def _same_pool(y, window: int, stride: int):
    """SAME max-pool over H and W of an NCHW tensor: -inf padding, the
    smaller half before."""
    pads = []
    for size in (y.shape[3], y.shape[2]):        # F.pad wants W first
        out = -(-size // stride)
        tot = max((out - 1) * stride + window - size, 0)
        pads += [tot // 2, tot - tot // 2]
    y = F.pad(y, pads, value=float("-inf"))
    return F.max_pool2d(y, window, stride)


def cnn_flat_width(spec) -> int:
    size = spec["height"]
    for _ in range(spec["conv_layers"]):
        size = -(-size // spec["pool_stride"])
    return size * size * spec["filters"]


def cnn_forward(p, x, spec, keep=None, dropout: float = 0.0):
    y = x.permute(0, 3, 1, 2)                              # NHWC -> NCHW
    for i in range(spec["conv_layers"]):
        w = p[f"c{i}"].permute(3, 2, 0, 1)                 # HWIO -> OIHW
        y = F.conv2d(y, w, padding=spec["kernel"] // 2)
        y = _same_pool(torch.relu(y), spec["pool_window"], spec["pool_stride"])
    y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)      # flatten NHWC
    for i in range(len(spec["fc"])):
        y = torch.relu(y @ p[f"fc{i}"]["w"] + p[f"fc{i}"]["b"])
    return y @ p["out"]["w"] + p["out"]["b"]


FORWARD = {"lstm": lstm_forward, "cnn": cnn_forward}


def logits(params, feats, config, seed=None, dropout: float = 0.0):
    """{modality: [B, C]} for the modalities in ``feats``; ``seed`` (a
    client's round seed) turns the LSTM dropout on."""
    out = {}
    for m, x in feats.items():
        spec = config["modalities"][m]
        keep = None
        if seed is not None and dropout > 0 and spec["kind"] == "lstm":
            keep = dropout_keep(seed, m, x.shape[0],
                                (x.shape[1], spec["hidden"]), dropout,
                                x.device)
        out[m] = FORWARD[spec["kind"]](params[m], x, spec, keep, dropout)
    return out


def multimodal_loss(modal_logits, labels, v_weights):
    """H = F + Σ_m v_m·G_m (Eqs. 1-4) over one client's samples: F the
    cross-entropy of the mean of the modalities' logits, G_m each
    modality's own cross-entropy."""
    fused = sum(modal_logits.values()) / len(modal_logits)
    total = F.cross_entropy(fused, labels)
    for m, lg in modal_logits.items():
        total = total + v_weights[m] * F.cross_entropy(lg, labels)
    return total
