"""Per-architecture step factories: init / train_step / prefill /
serve_step, the port of the JAX package's ``launch/steps.py``.

Optimizer selection is memory-aware, as there: Adafactor (factored second
moments) from ``ADAFACTOR_THRESHOLD`` parameters on, AdamW below.
``init_fn(cfg)`` takes a ``torch.Generator`` in place of a JAX key and puts
the params on the generator's device.

The train step runs eagerly: ``torch.autograd.grad`` over the param
leaves, then ``optimizer.update`` and ``apply_updates``.  ``impl="pallas"``
(the default, as for ``make_bulk_prefill``) routes, on a card, attention
through the flash-attention kernel (kernel forward, plain recompute
backward), Mamba2 through the SSD chunk kernel, and the audio and VLM
decision-fusion losses through the fusion-loss forward and backward
kernels (``fused_multimodal_loss``); on the CPU the same token runs their
plain versions.  ``impl="xla"`` is the plain path everywhere (the JAX
package's name), with the losses of ``core.fusion``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import dtensor_layouts as DL
from ..core import fusion
from ..core.trees import tree_leaves, tree_map
from ..device import graph_capture
from ..kernels.fusion_loss.ops import fused_multimodal_loss
from ..models import encdec, multimodal, transformer as T
from ..models.config import ModelConfig
from ..optim import adafactor, adamw, apply_updates

ADAFACTOR_THRESHOLD = 30e9


def init_fn(cfg: ModelConfig) -> Callable:
    """``gen -> params`` on ``gen``'s device (``gen=None`` under
    ``torch.device("meta")``: shapes only)."""
    if cfg.arch_type == "audio":
        return lambda gen: encdec.init_params(gen, cfg)
    if cfg.arch_type == "vlm":
        return lambda gen: multimodal.init_vlm_params(gen, cfg)
    return lambda gen: T.init_params(gen, cfg)


def params_shape(cfg: ModelConfig):
    """The params tree as meta tensors: shapes and dtypes, no memory."""
    with torch.device("meta"):
        return init_fn(cfg)(None)


def param_count(shapes) -> int:
    return int(sum(x.numel() for x in tree_leaves(shapes)))


def make_optimizer(cfg: ModelConfig, n_params: Optional[int] = None,
                   lr=1e-4):
    """(optimizer, name): Adafactor from ``ADAFACTOR_THRESHOLD`` params
    on (``n_params`` default: the config's count, from meta tensors),
    AdamW below."""
    if n_params is None:
        n_params = param_count(params_shape(cfg))
    if n_params >= ADAFACTOR_THRESHOLD:
        return adafactor(lr), "adafactor"
    return adamw(lr), "adamw"


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _fusion_loss(modal, labels, impl: str):
    """F + Σ_m G_m of ``{modality: logits}`` against labels [B, S]: the
    fusion-loss kernels (K=1, a broadcast head compact) or
    ``core.fusion``.  The kernels read one operand type: a head of
    another type (the float32 audio head beside bfloat16 text logits)
    goes in at the text logits' type."""
    if impl == "pallas":
        dt = modal["text"].dtype
        total, _ = fused_multimodal_loss(
            {m: lg[None].to(dt) for m, lg in modal.items()}, labels[None])
        return total[0]
    return fusion.multimodal_loss(modal, labels)[0]


def make_loss_fn(cfg: ModelConfig, *, n_groups: int = 1,
                 attn_chunk: int = 1024, aux_weight: float = 0.01,
                 impl: str = "pallas", **bk):
    """``loss(params, batch) -> 0-d loss``.  Extra keyword levers, threaded
    to the backbone: ``loss_chunk`` (the unembedding and CE over sequence
    chunks), ``remat`` (checkpoint each super-block)."""
    if cfg.arch_type == "vlm":
        loss_chunk = bk.pop("loss_chunk", None)
        if loss_chunk:
            def loss(params, batch):
                total, aux = multimodal.vlm_loss_chunked(
                    params, batch, cfg, loss_chunk, n_groups=n_groups,
                    attn_chunk=attn_chunk, impl=impl, **bk)
                return total + aux_weight * aux
            return loss

        def loss(params, batch):
            modal, aux = multimodal.vlm_modal_logits(
                params, batch, cfg, n_groups=n_groups, attn_chunk=attn_chunk,
                impl=impl, **bk)
            return _fusion_loss(modal, batch["labels"], impl) \
                + aux_weight * aux
        return loss
    if cfg.arch_type == "audio":
        bk.pop("loss_chunk", None)

        def loss(params, batch):
            enc = encdec.encode(params, batch["src_embeds"], cfg,
                                attn_chunk=attn_chunk)
            text = encdec.decode_fwd(params, batch["tokens"], enc, cfg,
                                     attn_chunk=attn_chunk, impl=impl)
            audio = encdec.audio_head_logits(params, enc)[:, None, :]
            return _fusion_loss({"text": text, "audio": audio},
                                batch["labels"], impl)
        return loss

    def loss(params, batch):
        return T.loss_fn(params, batch, cfg, n_groups=n_groups,
                         attn_chunk=attn_chunk, aux_weight=aux_weight,
                         impl=impl, **bk)
    return loss


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): the loss and its gradient with respect to every
    param leaf (``torch.autograd.grad``; a leaf the loss does not reach
    gets zeros), as ``jax.value_and_grad`` gives them."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    tracked = tree_map(lambda _: next(it), params)
    loss = loss_fn(tracked, batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(live, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig, optimizer, *, n_groups: int = 1,
                    attn_chunk: int = 1024, **bk):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: value and grads, ``optimizer.update``, ``apply_updates``, as
    the JAX package's step (run eagerly; ``impl`` and the levers as for
    ``make_loss_fn``)."""
    loss_fn = make_loss_fn(cfg, n_groups=n_groups, attn_chunk=attn_chunk,
                           **bk)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads
        return apply_updates(params, updates), opt_state, loss

    return train_step


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig, *, n_groups: int = 1,
                      attn_chunk: int = 1024, **bk):
    """``prefill(params, batch) -> last-position logits [B, V]`` (no
    cache); a VLM's are the fused logits of Eq. (1)."""
    bk.pop("loss_chunk", None)
    if cfg.arch_type == "vlm":
        def prefill(params, batch):
            with torch.no_grad():
                fused, _, _ = multimodal.vlm_fused_forward(
                    params, batch, cfg, n_groups=n_groups,
                    attn_chunk=attn_chunk, **bk)
            return fused[:, -1, :]
        return prefill
    if cfg.arch_type == "audio":
        def prefill(params, batch):
            enc = encdec.encode(params, batch["src_embeds"], cfg,
                                attn_chunk=attn_chunk)
            logits = encdec.decode_fwd(params, batch["tokens"], enc, cfg,
                                       attn_chunk=attn_chunk)
            return logits[:, -1, :]
        return prefill

    def prefill(params, batch):
        return T.prefill(params, batch["tokens"], cfg, n_groups=n_groups,
                         attn_chunk=attn_chunk, **bk)
    return prefill


def make_bulk_prefill(cfg: ModelConfig, *, n_groups: int = 1,
                      attn_chunk: int = 1024, impl: str = "pallas"):
    """Bulk prefill with cache export: the whole prompt in one pass.

    Dense/ssm archs: ``(params, tokens [B,S], cache) -> (next_token [B,1],
    cache)``; audio archs take the encoder output too: ``(params, tokens,
    enc, cache)``.  The cache, filled in place, stands at ``index=S`` —
    where S teacher-forced ``serve_step`` calls leave it.  ``impl="pallas"``
    runs the attention and SSD contractions through their kernels on a
    card, ``"xla"`` through the plain path.  A VLM prefills its text
    backbone (the vision head's bias is the sampling layer's, as in the
    JAX package)."""
    if cfg.arch_type == "audio":
        def bulk_prefill(params, tokens, enc, cache):
            logits, cache = encdec.prefill_with_cache(
                params, tokens, enc, cache, cfg, attn_chunk=attn_chunk,
                impl=impl)
            return logits.argmax(-1)[:, None], cache
        return bulk_prefill

    def bulk_prefill(params, tokens, cache):
        logits, cache = T.prefill_with_cache(params, tokens, cache, cfg,
                                             n_groups=n_groups,
                                             attn_chunk=attn_chunk, impl=impl)
        return logits.argmax(-1)[:, None], cache
    return bulk_prefill


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: ``(params, cache, token, index) ->
    (next_token [B,1], cache)``, the cache written in place; ``index`` an
    int or a 0-d device tensor."""
    step = encdec.decode_step if cfg.arch_type == "audio" else T.decode_step

    def serve_step(params, cache, token, index):
        logits, cache = step(params, cache, token, index, cfg)
        return DL.argmax(logits), cache
    return serve_step


class CapturedStep:
    """``body()`` — a step that reads and writes only tensors allocated
    outside it, in place, and reads nothing back to the host — run as one
    CUDA graph on a card: its first call runs eagerly (on a side stream),
    which loads the kernel libraries and the cuBLAS handles; the second is
    captured and replayed, and every later call replays.  On the CPU every
    call runs ``body`` eagerly.  ``captures`` counts captures: the
    contract is many steps, one capture; a failed capture raises — there
    is no eager fallback on a card."""

    def __init__(self, body: Callable[[], None], device):
        self.body = body
        self.device = torch.device(device)
        self.warmed = False
        self.captures = 0
        self.replays = 0
        self.graph = None

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.body()
            return
        if self.graph is None:
            if not self.warmed:
                cur = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(self.device)
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    self.body()
                cur.wait_stream(side)
                self.warmed = True
                return
            g = torch.cuda.CUDAGraph()
            with graph_capture(g):
                self.body()
            self.graph = g
            self.captures += 1
        # a capture records the step without running it: replay it
        self.graph.replay()
        self.replays += 1
