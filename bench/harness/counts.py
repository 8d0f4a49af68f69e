"""Operations and bytes, counted from shapes and a configuration's widths.

Model FLOPs count the multiply-adds of the matrix products and
convolutions (two operations each) that the paper's models need, and
nothing else: no gate or activation elementwise work, no padding rows, no
clients or modalities that upload nothing.  Training a sample costs three
forward passes (the forward, and the backward's two products per layer).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np


def lstm_forward_flops(spec: Mapping, n_classes: int) -> int:
    """One sample through the LSTM submodel."""
    T, d_in, H, fc = spec["steps"], spec["input"], spec["hidden"], spec["fc"]
    per_step = 0
    for i in range(spec["layers"]):
        d = d_in if i == 0 else H
        per_step += 2 * (d * 4 * H + H * 4 * H)
    return T * per_step + 2 * H * fc + 2 * fc * n_classes


def cnn_forward_flops(spec: Mapping, n_classes: int) -> int:
    """One sample through the CNN submodel (SAME convolutions, stride 1)."""
    size, ci, k, f = spec["height"], spec["channels"], spec["kernel"], \
        spec["filters"]
    total = 0
    for _ in range(spec["conv_layers"]):
        total += 2 * size * size * f * k * k * ci
        size = -(-size // spec["pool_stride"])
        ci = f
    dims = [size * size * f] + list(spec["fc"]) + [n_classes]
    return total + sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def forward_flops(config: Mapping, modality: str) -> int:
    spec = config["modalities"][modality]
    fn = lstm_forward_flops if spec["kind"] == "lstm" else cnn_forward_flops
    return fn(spec, config["classes"])


def round_flops(config: Mapping, D, upload, n_test: int,
                evaluate: bool) -> float:
    """Model FLOPs of one round: the local updates of every client that
    uploads a modality, over its samples (``upload`` bool [M, K] in sorted
    modality order, ``D`` [K] samples a client), and the held-out forward
    on an eval round."""
    mods = sorted(config["modalities"])
    fwd = np.array([forward_flops(config, m) for m in mods], np.float64)
    up = np.asarray(upload, bool)
    train = 3.0 * float((up * np.asarray(D, np.float64)[None]).sum(-1) @ fwd)
    return train + (float(n_test * fwd.sum()) if evaluate else 0.0)


def fusion_entry_bytes(K: int, T: int, V: int, M: int) -> int:
    """The fusion loss's public entry, forward and backward, each operand
    read once and each result written once (float32 logits, int32
    labels): logits [M, K, T, V], labels and the sample mask [K, T], the
    per-client availability [M, K] and the upstream gradient [K] in; the
    per-client loss [K] and the logits' gradient [M, K, T, V] out."""
    return 4 * (2 * M * K * T * V + 2 * K * T + M * K + 2 * K)


def fusion_entry_flops(K: int, T: int, V: int, M: int) -> int:
    """Arithmetic of the same call: per row, the fused logits (M·V adds),
    a log-sum-exp and a gold logit for the fused row and each modality's
    (5·V each) forward, and each softmax gradient (4·V each) backward."""
    return K * T * (M * V + 5 * V * (M + 1) + 4 * V * (M + 1))
