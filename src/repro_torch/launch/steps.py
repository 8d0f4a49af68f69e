"""Per-architecture step factories, serving half: init, shapes, prefill and
the greedy decode step.

The train and optimizer half (``make_loss_fn``, ``make_train_step``,
``make_optimizer``) waits for ``optim/`` (ROADMAP.md Queue 1 item 10), as
do the VLM archs.  ``init_fn(cfg)`` takes a ``torch.Generator`` in place of
a JAX key and puts the params on the generator's device.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models import encdec, transformer as T
from ..models.config import ModelConfig

_VLM_QUEUED = ("the VLM functions of models/multimodal.py are not ported "
               "yet; ROADMAP.md Queue 1 item 10")


def _no_vlm(cfg: ModelConfig):
    if cfg.arch_type == "vlm":
        raise NotImplementedError(f"{cfg.name}: {_VLM_QUEUED}")


def init_fn(cfg: ModelConfig) -> Callable:
    """``gen -> params`` on ``gen``'s device (``gen=None`` under
    ``torch.device("meta")``: shapes only)."""
    _no_vlm(cfg)
    if cfg.arch_type == "audio":
        return lambda gen: encdec.init_params(gen, cfg)
    return lambda gen: T.init_params(gen, cfg)


def params_shape(cfg: ModelConfig):
    """The params tree as meta tensors: shapes and dtypes, no memory."""
    with torch.device("meta"):
        return init_fn(cfg)(None)


def param_count(shapes) -> int:
    from ..core.trees import tree_leaves
    return int(sum(x.numel() for x in tree_leaves(shapes)))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig, *, n_groups: int = 1,
                      attn_chunk: int = 1024, **bk):
    """``prefill(params, batch) -> last-position logits [B, V]`` (no
    cache)."""
    _no_vlm(cfg)
    bk.pop("loss_chunk", None)
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
    card, ``"xla"`` through the plain path."""
    _no_vlm(cfg)
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
    _no_vlm(cfg)
    step = encdec.decode_step if cfg.arch_type == "audio" else T.decode_step

    def serve_step(params, cache, token, index):
        logits, cache = step(params, cache, token, index, cfg)
        return logits.argmax(-1), cache
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
            with torch.cuda.graph(g):
                self.body()
            self.graph = g
            self.captures += 1
        # a capture records the step without running it: replay it
        self.graph.replay()
        self.replays += 1
