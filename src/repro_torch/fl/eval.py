"""Test-set evaluation — the Table-3 metrics.

Every headline number of the paper (Table 3, Figs. 4-6) is a held-out-split
metric: multimodal accuracy (Eq. 1 fused logits), per-modality unimodal
accuracy, and the fused cross-entropy.  ``eval_metrics`` computes them from
the same forward pass the training step uses, as tensors on the params'
device: the host API (``ModelAdapter.evaluate``) reads them back; the fused
round (fl/fused_round.py) keeps them on the device on the rounds its eval
cadence flags, and ``nan_metrics`` fills the others.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..core import fusion
from ..core.trees import tree_leaves, tree_map
from ..models import paper_models as pm

#: metric keys shared by every evaluation surface, before the per-modality
#: accuracy entries
BASE_METRICS = ("multimodal", "loss")


def metric_keys(mods) -> Tuple[str, ...]:
    """Canonical key order of an ``eval_metrics`` result dict."""
    return BASE_METRICS + tuple(sorted(mods))


def paper_logits(params, feats):
    """One model's deterministic [B, C] logits per modality: the stacked
    paper models run on a cohort of one."""
    one = {m: tree_map(lambda x: x[None], params[m]) for m in feats}
    out = pm.modal_logits(one, {m: x[None] for m, x in feats.items()})
    return {m: lg[0] for m, lg in out.items()}


@torch.no_grad()
def eval_metrics(params: Mapping[str, dict],
                 feats: Mapping[str, torch.Tensor], labels: torch.Tensor, *,
                 logits_fn=None) -> Dict[str, torch.Tensor]:
    """Test-split metrics as 0-d float32 tensors: Eq. 1 fused accuracy (key
    ``multimodal``), fused cross-entropy (``loss``) and one unimodal
    accuracy per modality present in ``feats``.

    ``logits_fn(params, feats) -> {modality: [B, C]}`` selects the model
    family (``ModelAdapter.eval_logits``); the default is the paper's
    LSTM/CNN forward."""
    if logits_fn is None:
        logits_fn = paper_logits
    logits = logits_fn({m: params[m] for m in feats}, dict(feats))
    fused = fusion.fuse_logits(logits)
    out = {"multimodal": fusion.accuracy(fused, labels),
           "loss": fusion.softmax_xent(fused, labels)}
    for m in feats:
        out[m] = fusion.accuracy(logits[m], labels)
    return out


def nan_metrics(mods, device=None) -> Dict[str, torch.Tensor]:
    """``eval_metrics``' keys with every value a float32 NaN — what a round
    off the eval cadence emits (consumers gate on the round's eval flag,
    never on the fillers)."""
    return {k: torch.full((), float("nan"), dtype=torch.float32,
                          device=device) for k in metric_keys(mods)}


def device_test_set(test_ds, device) -> Tuple[Dict[str, torch.Tensor],
                                              torch.Tensor]:
    """A dataset's features and labels on ``device``, moved once (the fused
    engine holds them for the experiment's lifetime)."""
    feats = {m: torch.as_tensor(np.asarray(x), device=device)
             for m, x in sorted(test_ds.features.items())}
    return feats, torch.as_tensor(np.asarray(test_ds.labels), device=device)


def eval_metrics_stacked(stacked_params, feats, labels, *, logits_fn=None
                         ) -> Dict[str, torch.Tensor]:
    """``eval_metrics`` over a leading axis of ``stacked_params`` (one row
    per scenario): a dict of [S] tensors."""
    S = tree_leaves(stacked_params)[0].shape[0]
    rows = [eval_metrics(tree_map(lambda x: x[s], stacked_params), feats,
                         labels, logits_fn=logits_fn) for s in range(S)]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
