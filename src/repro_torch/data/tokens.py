"""Synthetic token-stream pipeline for the LM-scale architectures.

Deterministic, seekable synthetic corpus: a mixture of Zipfian unigrams and a
repeated-ngram process so the LM loss actually decreases during the example
training runs.  Batches are produced host-side as numpy and moved to the
device by the caller (``launch/train.py``).  The port's copy of the JAX
package's ``data/tokens.py``: numpy only, the same draws in the same
order, so both packages train on identical batches at the same seed.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, min(vocab_size, 50000) + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self.p = p / p.sum()
        self.support = len(ranks)

    def batch(self, batch_size: int, seq_len: int) -> dict:
        toks = self.rng.choice(self.support, size=(batch_size, seq_len + 1),
                               p=self.p).astype(np.int32)
        # inject copyable structure: repeat a prefix window later in the seq
        if seq_len >= 64:
            w = 16
            start = self.rng.integers(0, seq_len // 2)
            dst = self.rng.integers(seq_len // 2, seq_len - w)
            toks[:, dst:dst + w] = toks[:, start:start + w]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def vlm_batch(rng: np.random.Generator, batch: int, seq: int, n_patches: int,
              d_patch: int, vocab: int) -> dict:
    toks = rng.integers(0, min(vocab, 50000), size=(batch, seq + 1),
                        dtype=np.int32)
    patches = rng.normal(size=(batch, n_patches, d_patch)).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "patches": patches}
