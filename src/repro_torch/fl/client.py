"""FL client-side computation: the local update of Algorithm 1, lines 4-6.

One epoch of batch gradient descent (BGD) on the local dataset per round, per
§II-A.  The loss is H_k = F_k + Σ_m v_m·G_{k,m} (Eq. 4); only the client's
available modalities are updated (missing submodels contribute exactly
zero).

``ModelAdapter`` owns the architecture-agnostic parts — the whole-cohort BGD
step, the loss-backend selection, eval — and ``PaperModelAdapter`` supplies
the paper's LSTM/CNN submodels (models/paper_models.py).

The cohort step computes every client's gradient without ``vmap``: the
global params are expanded to [K, ...] leaf stacks, the per-client totals
are summed (client k's total depends only on its own slice) and one
backward pass yields exactly the per-client gradients.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..core import fusion
from ..core.trees import tree_leaves, tree_map, tree_sq_dist
from ..kernels.fusion_loss import ops as fusion_kops
from ..models import paper_models as pm
from .eval import eval_metrics, paper_logits

LOSS_BACKENDS = ("xla", "pallas")


class ModelAdapter:
    """Architecture-agnostic local-update machinery (Algorithm 1, ll. 4-6).

    Subclasses define the model family via ``init_global`` (global params)
    and ``modal_logits`` (per-modality logits of a per-client stack);
    everything else — BGD step, loss backend, eval — is shared.

    ``loss_backend`` keeps the JAX package's names: ``"xla"`` is the plain
    PyTorch loss (``core.fusion``, one client at a time), ``"pallas"`` the
    CUDA fusion-loss kernel over the whole cohort (``kernels/fusion_loss``).
    """

    #: default pre-set modal weights v_m (Eq. 3); subclasses override
    DEFAULT_V: Dict[str, float] = {"audio": 1.0, "text": 1.0, "image": 1.0}

    def __init__(self, dataset_name: str, eta: float = 0.05,
                 v_weights: Optional[Mapping[str, float]] = None,
                 dropout: float = 0.1, loss_backend: str = "xla"):
        if loss_backend not in LOSS_BACKENDS:
            raise ValueError(
                f"unknown loss_backend {loss_backend!r}; expected "
                f"'xla' (plain core.fusion) or 'pallas' (the CUDA "
                f"fusion-loss kernel)")
        self.dataset_name = dataset_name
        self.eta = eta
        self.v_weights = dict(self.DEFAULT_V if v_weights is None
                              else v_weights)
        self.dropout = dropout
        self.loss_backend = loss_backend

    # ------------------------------------------------------------------
    # the architecture: subclasses implement these two
    # ------------------------------------------------------------------
    def init_global(self, generator: torch.Generator,
                    device) -> Dict[str, dict]:
        """Global model: {modality: {name: tensor}} on ``device``."""
        raise NotImplementedError

    def modal_logits(self, params, inputs: dict, *, dropout_seeds=None):
        """Per-modality [K, B, C] logits of per-client stacks."""
        raise NotImplementedError

    def eval_logits(self, params, inputs: dict):
        """Deterministic (no-dropout) [B, C] logits of one model."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def cohort_loss(self, logits, labels, avail, sample_mask, v_weights):
        """Per-client totals [K] of H_k = F + Σ v_m·G_m, backend-selected."""
        if self.loss_backend == "pallas":
            total, _ = fusion_kops.fused_multimodal_loss(
                logits, labels, v_weights, avail=avail,
                sample_mask=sample_mask)
            return total
        return torch.stack([
            fusion.multimodal_loss(
                {m: lg[k] for m, lg in logits.items()}, labels[k],
                v_weights, avail={m: a[k] for m, a in avail.items()},
                sample_mask=sample_mask[k])[0]
            for k in range(labels.shape[0])])

    def cohort_step(self, params, init_params, feats, labels, smask, avail,
                    seeds):
        """One BGD epoch for every client of the padded stack at once.

        ``params``/``init_params``: global {m: {name: tensor}}; ``feats[m]``
        [K, N, ...]; ``labels``/``smask`` [K, N]; ``avail[m]`` float 0/1 [K];
        ``seeds`` int64 [K] dropout seeds.  Returns [K]-leading stacks: new
        params, grads, per-client totals and per-modality squared distance
        of the new params to ``init_params``."""
        mods = tuple(sorted(feats))
        K = labels.shape[0]
        v_weights = {m: self.v_weights.get(m, 1.0) for m in mods}
        stacked = {m: tree_map(lambda x: x.detach().expand(K, *x.shape)
                               .clone().requires_grad_(), params[m])
                   for m in mods}
        logits = self.modal_logits(stacked, feats, dropout_seeds=seeds)
        totals = self.cohort_loss(logits, labels, avail, smask, v_weights)
        # sum, not mean: each client's gradient lands in its own slice
        leaves = tree_leaves(stacked)
        it = iter(torch.autograd.grad(totals.sum(), leaves))
        grads = tree_map(lambda _: next(it), stacked)
        new = tree_map(lambda p, g: p.detach() - self.eta * g, stacked, grads)
        dist_sq = {m: tree_sq_dist(new[m], init_params[m], lead=1)
                   for m in mods}
        return new, grads, totals.detach(), dist_sq

    def batched_local_update(self, global_params: Mapping[str, dict],
                             init_params: Mapping[str, dict],
                             feats: Mapping[str, torch.Tensor],
                             labels: torch.Tensor,
                             sample_mask: torch.Tensor,
                             avail: Mapping[str, np.ndarray],
                             seeds: np.ndarray):
        """``cohort_step`` from host masks: ``avail`` a per-modality 0/1
        upload mask [K] and ``seeds`` the per-client dropout seeds.  A
        masked-out modality contributes exactly zero to the loss, so its
        gradient is exactly zero and its "new" params equal the globals —
        aggregation masks them out again."""
        mods = tuple(sorted(feats))
        dev = labels.device
        avail_t = {m: torch.as_tensor(np.asarray(avail[m], np.float32),
                                      device=dev) for m in mods}
        seeds_t = torch.as_tensor(np.asarray(seeds, np.int64), device=dev)
        return self.cohort_step(
            {m: global_params[m] for m in mods},
            {m: init_params[m] for m in mods},
            {m: feats[m] for m in mods}, labels, sample_mask, avail_t,
            seeds_t)

    # ------------------------------------------------------------------
    def evaluate(self, params: Mapping[str, dict], test) -> Dict[str, float]:
        dev = tree_leaves(params)[0].device
        feats = {m: torch.as_tensor(x, device=dev)
                 for m, x in sorted(test.features.items())}
        labels = torch.as_tensor(test.labels, device=dev)
        out = eval_metrics(params, feats, labels, logits_fn=self.eval_logits)
        return {k: float(v) for k, v in out.items()}


class PaperModelAdapter(ModelAdapter):
    """Decision-fusion multimodal model made of the paper's submodels."""

    # Default pre-set modal weights v_m (Eq. 3), the JAX package's calibration
    DEFAULT_V = {"audio": 6.0, "text": 4.0, "image": 1.0}

    def init_global(self, generator: torch.Generator,
                    device) -> Dict[str, dict]:
        if self.dataset_name == "crema_d":
            params = pm.init_crema_model(generator)
        elif self.dataset_name == "iemocap":
            params = pm.init_iemocap_model(generator)
        else:
            raise ValueError(self.dataset_name)
        return tree_map(lambda x: x.to(device), params)

    def modal_logits(self, params, inputs: dict, *, dropout_seeds=None):
        return pm.modal_logits(params, inputs, dropout_seeds=dropout_seeds,
                               dropout=self.dropout)

    def eval_logits(self, params, inputs: dict):
        return paper_logits(params, inputs)


def make_adapter(dataset_name: str, arch: str = "lstm-cnn",
                 **kw) -> ModelAdapter:
    """Adapter for one point of the architecture axis; this slice of the
    port carries the paper's ``"lstm-cnn"`` submodels only."""
    if arch == "lstm-cnn":
        return PaperModelAdapter(dataset_name, **kw)
    if arch in ("transformer", "ssd"):
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; it is ROADMAP.md Queue 1 "
            f"item 8 (the backbone slice)")
    raise ValueError(f"unknown arch {arch!r}")
