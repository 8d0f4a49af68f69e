"""Per-modality global aggregation — Eqs. (9)-(12) of the paper.

The global multimodal model is the stack of per-modality submodels.  In round
t only participating clients that *have* modality m contribute to submodel m;
their weights are renormalised to the participated aggregation weight
``w^t_{k,m} = D_k / sum_{i in K_m^t} D_i`` (Eq. 12).  If no participant has
modality m, the submodel is unchanged.

The weights are host numpy (float64), as in the JAX package; the contraction
over the client axis of the [K, ...] parameter and gradient stacks runs on
the stacks' device in float32.  These are the helpers the batched round loop
uses; the sequential and traced forms are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .trees import tree_map


def stacked_weights(data_sizes: Sequence[int],
                    upload_mask: Mapping[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
    """Eq. 12 weights from a contributor mask: ``upload_mask[m]`` is a bool
    [K] marking the clients contributing to submodel m."""
    D = np.asarray(data_sizes, np.float64)
    out = {}
    for m, mask in upload_mask.items():
        w = np.where(np.asarray(mask, bool), D, 0.0)
        tot = w.sum()
        out[m] = w / tot if tot > 0 else w
    return out


def unified_weights(data_sizes: Sequence[int],
                    modalities: Sequence[Sequence[str]],
                    all_modalities: Sequence[str]) -> Dict[str, np.ndarray]:
    """w̄_{k,m} over the full population K_m (Eq. 9)."""
    return stacked_weights(data_sizes, {
        m: np.array([m in mods for mods in modalities])
        for m in all_modalities})


def _contract(w: np.ndarray, tree):
    """Σ_k w_k x_k over the leading client axis of every leaf."""
    def one(x):
        wt = torch.as_tensor(w, dtype=torch.float32, device=x.device)
        return torch.tensordot(wt, x, dims=1)
    return tree_map(one, tree)


def aggregate_stacked(global_params: Mapping[str, dict],
                      stacked_params: Mapping[str, dict],
                      weights: Mapping[str, np.ndarray]) -> Dict[str, dict]:
    """θ^t_{g,m} = Σ_k w^t_{k,m} θ^t_{k,m} over [K, ...] leaf stacks.
    Zero-weight rows drop out of the contraction; if Σ_k w_{k,m} == 0 the
    global submodel m is returned unchanged."""
    new_global: Dict[str, dict] = {}
    for m, g_sub in global_params.items():
        w = weights[m]
        if m not in stacked_params or w.sum() <= 0:
            new_global[m] = g_sub
            continue
        new_global[m] = _contract(w, stacked_params[m])
    return new_global


def aggregate_gradients_stacked(stacked_grads: Mapping[str, dict],
                                weights: Mapping[str, np.ndarray]
                                ) -> Dict[str, dict]:
    """∇H(θ_{g,m}) = Σ_k w_{k,m} ∇H_k(θ_{g,m}) (Eq. 9) over [K, ...]
    gradient stacks; modalities with no contributor are omitted."""
    return {m: _contract(weights[m], g) for m, g in stacked_grads.items()
            if weights[m].sum() > 0}
