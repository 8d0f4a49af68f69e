"""FL client-side computation: the local update of Algorithm 1, lines 4-6.

One epoch of batch gradient descent (BGD) on the local dataset per round, per
§II-A.  The loss is H_k = F_k + Σ_m v_m·G_{k,m} (Eq. 4); only the client's
available modalities are updated (missing submodels contribute exactly
zero).

``ModelAdapter`` owns the architecture-agnostic parts — the whole-cohort BGD
step, the loss-backend selection, optional remat, eval — and subclasses
supply the model family:

* ``PaperModelAdapter`` — the paper's LSTM/CNN submodels
  (models/paper_models.py);
* ``BackboneAdapter`` — transformer- or SSD-backed unimodal encoders
  (models/multimodal.py over ``ENCODER_PRESETS``), optionally routing the
  mixers through the flash-attention / SSD CUDA kernels
  (``use_kernels=True``).

The cohort step computes every client's gradient without ``vmap``: the
global params are expanded to [K, ...] leaf stacks, the per-client totals
are summed (client k's total depends only on its own slice) and one
backward pass yields exactly the per-client gradients.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core import fusion
from ..core.trees import tree_leaves, tree_map, tree_sq_dist
from ..data.scenarios import DATASET_SHAPES
from ..kernels.fusion_loss import ops as fusion_kops
from ..models import multimodal as mm
from ..models import paper_models as pm
from ..models.config import FL_ARCHS, encoder_config
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
    ``remat`` checkpoints the cohort forward (``torch.utils.checkpoint``):
    the backward recomputes its activations instead of holding them.
    """

    #: default pre-set modal weights v_m (Eq. 3); subclasses override
    DEFAULT_V: Dict[str, float] = {"audio": 1.0, "text": 1.0, "image": 1.0}

    def __init__(self, dataset_name: str, eta: float = 0.05,
                 v_weights: Optional[Mapping[str, float]] = None,
                 dropout: float = 0.1, loss_backend: str = "xla",
                 remat: bool = False):
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
        self.remat = remat

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
        def forward():
            logits = self.modal_logits(stacked, feats, dropout_seeds=seeds)
            return self.cohort_loss(logits, labels, avail, smask, v_weights)

        # the forward draws no torch random bits (dropout is a counter
        # hash), so no RNG state is stashed: a CUDA graph can capture it
        totals = (checkpoint(forward, use_reentrant=False,
                             preserve_rng_state=False) if self.remat
                  else forward())
        # sum, not mean: each client's gradient lands in its own slice
        leaves = tree_leaves(stacked)
        it = iter(torch.autograd.grad(totals.sum(), leaves))
        grads = tree_map(lambda _: next(it), stacked)
        new = tree_map(lambda p, g: p.detach() - self.eta * g, stacked, grads)
        dist_sq = {m: tree_sq_dist(new[m], init_params[m], lead=1)
                   for m in mods}
        return new, grads, totals.detach(), dist_sq

    def local_update(self, global_params: Mapping[str, dict], client,
                     seed: int, dropout_modality: Optional[str] = None):
        """One BGD epoch on one client's unpadded shard (the ``seq``
        loop): ``cohort_step`` on a cohort of one, every sample real and
        every trained modality available, so with ``pallas`` the loss is
        the fusion kernel at K=1 and T = the shard size.  ``seed`` is the
        client's dropout seed; the per-sample dropout keys make the masks
        those of the same client in the batched loop's padded stack.

        Returns (updated params, grads, total loss) of the modalities the
        client trains (its own, less ``dropout_modality`` unless that is
        its only one)."""
        mods = tuple(m for m in client.modalities if m != dropout_modality)
        if not mods:
            mods = tuple(client.modalities)
        mods = tuple(sorted(mods))
        dev = tree_leaves(global_params)[0].device
        ds = client.dataset
        feats = {m: torch.as_tensor(np.asarray(ds.features[m]),
                                    device=dev)[None] for m in mods}
        labels = torch.as_tensor(np.asarray(ds.labels), device=dev)[None]
        ones = torch.ones(1, dtype=torch.float32, device=dev)
        new, grads, totals, _ = self.cohort_step(
            {m: global_params[m] for m in mods},
            {m: global_params[m] for m in mods}, feats, labels,
            torch.ones(labels.shape, dtype=torch.float32, device=dev),
            {m: ones for m in mods},
            torch.tensor([int(seed)], dtype=torch.int64, device=dev))
        first = lambda x: x[0]                                # noqa: E731
        return (tree_map(first, new), tree_map(first, grads),
                float(totals[0]))

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


class BackboneAdapter(ModelAdapter):
    """Transformer- or SSD-backed unimodal encoders under decision fusion.

    Each modality's feature stack runs through a small sequence encoder
    (``models.config.ENCODER_PRESETS``) to C-class logits; fusion, loss and
    aggregation are the shared machinery.  ``use_kernels=True`` routes the
    mixers through the flash-attention / SSD CUDA kernels (the backward
    recomputes through the plain path), in the cohort step and in eval."""

    DEFAULT_V = {"audio": 1.0, "text": 1.0, "image": 1.0}

    def __init__(self, dataset_name: str, arch: str = "transformer",
                 use_kernels: bool = False, **kw):
        super().__init__(dataset_name, **kw)
        self.arch = arch
        self.use_kernels = use_kernels
        self.cfg = encoder_config(arch)

    @property
    def _impl(self) -> str:
        return "pallas" if self.use_kernels else "xla"

    def init_global(self, generator: torch.Generator,
                    device) -> Dict[str, dict]:
        shapes, n_classes = DATASET_SHAPES[self.dataset_name]
        return {m: tree_map(lambda x: x.to(device), mm.init_encoder(
                    generator, int(np.prod(shapes[m][1:])), n_classes,
                    self.cfg))
                for m in sorted(shapes)}

    def _logits(self, params, inputs, dropout_seeds, remat):
        out = {}
        for m in sorted(inputs):
            # the paper models' per-modality stream constants, so a
            # modality-subset call and the full stack draw the same masks
            keys = (None if dropout_seeds is None
                    else pm.fold_in(dropout_seeds, pm.MODALITY_INDEX[m]))
            out[m] = mm.encoder_apply(
                params[m], inputs[m], self.cfg, dropout_keys=keys,
                dropout=self.dropout, remat=remat, impl=self._impl)
        return out

    def modal_logits(self, params, inputs: dict, *, dropout_seeds=None):
        return self._logits(params, inputs, dropout_seeds, self.remat)

    def eval_logits(self, params, inputs: dict):
        """One model's [B, C] logits per modality, run as a cohort of
        one."""
        one = {m: tree_map(lambda x: x[None], params[m]) for m in inputs}
        out = self._logits(one, {m: x[None] for m, x in inputs.items()},
                           None, False)
        return {m: lg[0] for m, lg in out.items()}


def make_adapter(dataset_name: str, arch: str = "lstm-cnn",
                 use_kernels: bool = False, **kw) -> ModelAdapter:
    """Adapter for one point of the architecture axis (``FL_ARCHS``)."""
    if arch == "lstm-cnn":
        return PaperModelAdapter(dataset_name, **kw)
    if arch not in FL_ARCHS:
        raise ValueError(f"unknown arch {arch!r}; choose from {FL_ARCHS}")
    return BackboneAdapter(dataset_name, arch=arch, use_kernels=use_kernels,
                           **kw)
