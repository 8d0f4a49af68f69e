# Frozen copy of src/repro/data/synthetic.py (numpy only), kept verbatim so the
# reference derives the same inputs from the seed without importing the
# program.  Edited only where it imported its package.
"""Synthetic multimodal datasets standing in for CREMA-D / IEMOCAP.

The real corpora are not available offline (repro gate, DESIGN.md §2).  We
generate classification data whose *structure* matches the paper's setup:

* crema_like  — audio [T=32, 11] sequences + image [32, 32, 3], 6 classes.
* iemocap_like — audio [T=32, 11] + text [T=24, 100] sequences, 10 classes.

Each modality draws class-conditional patterns with a modality-specific SNR;
audio gets the highest SNR so the audio submodel converges fastest — the
modality-imbalance phenomenon (§VI-B: "the audio submodel converges faster
than the image submodel") that JCSBA's Theorem-1 term exploits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class MultimodalDataset:
    name: str
    features: Dict[str, np.ndarray]     # modality -> [N, ...] float32
    labels: np.ndarray                  # [N] int32
    n_classes: int

    def __len__(self) -> int:
        return len(self.labels)

    def subset(self, idx) -> "MultimodalDataset":
        return MultimodalDataset(
            self.name, {m: x[idx] for m, x in self.features.items()},
            self.labels[idx], self.n_classes)


def _seq_modality(rng, labels, T, d, n_classes, snr):
    """Class-dependent temporal pattern + noise. [N, T, d]."""
    N = len(labels)
    protos = rng.normal(size=(n_classes, T, d)).astype(np.float32)
    # smooth prototypes along time so an LSTM can integrate evidence
    for _ in range(2):
        protos[:, 1:] = 0.5 * (protos[:, 1:] + protos[:, :-1])
    x = protos[labels] * snr + rng.normal(size=(N, T, d)).astype(np.float32)
    return x.astype(np.float32)


def _img_modality(rng, labels, hw, n_classes, snr):
    N = len(labels)
    protos = rng.normal(size=(n_classes, hw, hw, 3)).astype(np.float32)
    for _ in range(3):                                   # spatial smoothing
        protos[:, 1:] = 0.5 * (protos[:, 1:] + protos[:, :-1])
        protos[:, :, 1:] = 0.5 * (protos[:, :, 1:] + protos[:, :, :-1])
    x = protos[labels] * snr + rng.normal(size=(N, hw, hw, 3)).astype(np.float32)
    return x.astype(np.float32)


def crema_like(seed: int = 0, n: int = 1200,
               snr: Tuple[float, float] = (1.2, 1.0)) -> MultimodalDataset:
    """Audio converges fast (high SNR); image is the slow modality."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 6, n).astype(np.int32)
    return MultimodalDataset(
        "crema_d",
        {"audio": _seq_modality(rng, labels, 32, 11, 6, snr[0]),
         "image": _img_modality(rng, labels, 32, 6, snr[1])},
        labels, 6)


def iemocap_like(seed: int = 0, n: int = 1200,
                 snr: Tuple[float, float] = (1.2, 0.9)) -> MultimodalDataset:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    return MultimodalDataset(
        "iemocap",
        {"audio": _seq_modality(rng, labels, 32, 11, 10, snr[0]),
         "text": _seq_modality(rng, labels, 24, 100, 10, snr[1])},
        labels, 10)


DATASETS = {"crema_d": crema_like, "iemocap": iemocap_like}
