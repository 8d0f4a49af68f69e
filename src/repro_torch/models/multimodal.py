"""Decision-level-fusion wrappers: the FL harness's unimodal encoders and
the VLM's modal logits at LM scale.

The paper's architecture (Fig. 2) is M unimodal submodels whose logits are
averaged (parameter-free fusion), with a unimodal CE per modality added to
the objective (Eqs. 1-4).

FL encoders (``fl/client.py``), on per-client stacks: a small sequence
encoder — linear projection, the ``cfg`` block stack,
final norm, head — maps one modality's feature stack [K, B, T, *feat] to
C-class decision logits, in the role of the paper's LSTM/CNN submodels but
with the transformer / Mamba2 blocks (``ENCODER_PRESETS``).  Fusion and the
loss are shared with the paper models (``core.fusion``,
``kernels/fusion_loss``).

llava-next-34b (vlm), with no cohort axis: the text submodel is the LM
backbone on the text tokens; the vision submodel a light head on the
pooled patch embeddings (the frontend a stub, as in the JAX package),
whose vocab logits broadcast over the positions.  ``vlm_loss_chunked``
streams the unembedding and the fused and unimodal CEs over sequence
chunks; with ``impl="pallas"`` each chunk's text logits [B·c, V] and the
compact vision head [B, V] go to the fusion-loss kernels
(``kernels/fusion_loss.fused_multimodal_loss``, K=1, ``seg = c``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import dtensor_layouts as DL
from ..core.trees import tree_map
from ..kernels.fusion_loss.ops import fused_multimodal_loss
from . import transformer as T
from .config import ModelConfig
from .layers import dense, promote, randn
from .paper_models import dropout_keep


def init_encoder(gen: torch.Generator, d_in: int, n_classes: int,
                 cfg: ModelConfig):
    """One encoder's global params (no cohort axis): ``blocks`` leaves
    stacked [n_blocks, ...], with the JAX package's leaf names."""
    pattern = cfg.block_pattern()
    dt = cfg.param_dtype
    per_block = [{f"l{i}": T.init_layer(gen, cfg, spec)
                  for i, spec in enumerate(pattern)}
                 for _ in range(cfg.n_blocks)]

    return {
        "proj": {"w": (torch.randn((d_in, cfg.d_model), generator=gen)
                       / math.sqrt(d_in)).to(dt),
                 "b": torch.zeros((cfg.d_model,), dtype=dt)},
        "blocks": tree_map(lambda *xs: torch.stack(xs), *per_block),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt),
        "head": {"w": (torch.randn((cfg.d_model, n_classes), generator=gen)
                       / math.sqrt(cfg.d_model)).to(dt),
                 "b": torch.zeros((n_classes,), dtype=dt)},
    }


def encoder_apply(p, x, cfg: ModelConfig, *,
                  dropout_keys: Optional[torch.Tensor] = None,
                  dropout: float = 0.1, remat: bool = False,
                  impl: str = "xla"):
    """x: [K, B, T, *feat] -> logits [K, B, C].

    Trailing feature dims are flattened per time step (an image stack
    [K, B, 32, 32, 3] becomes a 32-step sequence of 96-dim rows).  Dropout
    (``dropout_keys`` [K], the per-client modality stream keys; ``None`` =
    none) acts on the pooled last-position representation with per-sample
    masks, so sample i's mask depends only on (key, i), never on the batch
    size — the same discipline as ``paper_models.lstm_apply``."""
    K, B, S = x.shape[:3]
    h = dense(p["proj"], x.reshape(K, B, S, -1))
    h, _ = T.backbone(p, h, cfg, attn_chunk=S, remat=remat, impl=impl)
    h = h[:, :, -1, :]                                       # [K, B, D]
    if dropout_keys is not None and dropout > 0.0:
        keep = dropout_keep(dropout_keys, B, h.shape[2:], dropout)
        h = torch.where(keep, h / (1.0 - dropout), torch.zeros_like(h))
    return dense(p["head"], h)


# ---------------------------------------------------------------------------
# the VLM (llava-next-34b): params with no cohort axis
# ---------------------------------------------------------------------------
def init_vlm_params(gen: Optional[torch.Generator], cfg: ModelConfig):
    """The LM's params (``transformer.init_params``) plus ``vision``:
    ``proj`` [d_patch, D] (patch embeddings -> d_model), ``w1`` [D, D] and
    ``w2`` [D, V] (the vision decision head, ``w2`` zeros)."""
    p = T.init_params(gen, cfg)
    d_patch = cfg.frontend_dims[0] if cfg.frontend_dims else cfg.d_model
    dt = cfg.param_dtype
    p["vision"] = {
        "proj": (randn(gen, (d_patch, cfg.d_model)) * 0.02).to(dt),
        "w1": (randn(gen, (cfg.d_model, cfg.d_model)) * 0.02).to(dt),
        "w2": torch.zeros((cfg.d_model, cfg.vocab_size), dtype=dt,
                          device=p["embed"].device),
    }
    return p


def _vision_logits(params, patches):
    """Pooled patches [B, P, d_patch] -> vision logits [B, V], in the
    promoted type as in the JAX package: float32 patches meeting bfloat16
    weights compute the whole head in float32."""
    pv = torch.matmul(*DL.matmul_operands(
        *promote(patches, params["vision"]["proj"])))
    h = F.gelu(torch.matmul(*DL.matmul_operands(
        *promote(pv.mean(dim=1), params["vision"]["w1"]))),
        approximate="tanh")
    return torch.matmul(*promote(h, params["vision"]["w2"]))


def vlm_modal_logits(params, batch, cfg: ModelConfig, *, n_groups: int = 1,
                     attn_chunk: int = 1024, **bk):
    """batch: {"tokens": [B, S], "patches": [B, P, d_patch]}.  Returns
    ({"text": [B, S, V], "vision": [B, 1, V]}, moe_aux); the vision logits
    broadcast over the positions in the fusion."""
    text, aux = T.forward(params, batch["tokens"], cfg, n_groups=n_groups,
                          attn_chunk=attn_chunk, **bk)
    return {"text": text,
            "vision": _vision_logits(params, batch["patches"])[:, None]}, aux


def vlm_fused_forward(params, batch, cfg: ModelConfig, **kw):
    """Fused logits per Eq. (1): the average of the modal logits."""
    modal, aux = vlm_modal_logits(params, batch, cfg, **kw)
    fused = 0.5 * (modal["text"] + modal["vision"])
    return fused, modal, aux


def vlm_loss_chunked(params, batch, cfg: ModelConfig, chunk: int, *,
                     n_groups: int = 1, attn_chunk: int = 1024,
                     impl: str = "xla", **bk):
    """The decision-fusion loss streamed over sequence chunks: the
    unembedding, the fused CE and both unimodal CEs a chunk at a time, so
    the [B, S, V] text and fused logits never exist at once.

    ``impl="pallas"`` routes the backbone's mixers through their kernels
    and each chunk's loss through the fusion-loss kernels (text [B·c, V]
    and the compact vision head [B, V], ``seg = c``, the head at the text
    logits' type since the kernels read one type; forward and backward);
    ``"xla"`` is the JAX package's plain chunk loop.  Returns
    (F + G_text + G_vision, moe_aux)."""
    tokens, labels, patches = batch["tokens"], batch["labels"], batch["patches"]
    x = T.embed_tokens(params, tokens, cfg)
    h, aux = T.lm_hidden(params, x, cfg, n_groups=n_groups,
                         attn_chunk=attn_chunk, impl=impl, **bk)
    vision = _vision_logits(params, patches)                  # [B, V]
    B, S, _ = h.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    nc = S // chunk
    if impl == "pallas":
        tot = h.new_zeros((), dtype=torch.float32)
        for t0 in range(0, S, chunk):
            text = T.unembed(params, h[:, t0:t0 + chunk], cfg)
            total, _ = fused_multimodal_loss(
                {"text": text[None],
                 "vision": vision[None, :, None].to(text.dtype)},
                labels[None, :, t0:t0 + chunk])
            tot = tot + total[0]
        return tot / nc, aux

    vision = vision.float()
    v_lse = DL.logsumexp(vision)                              # [B]
    t_tot = h.new_zeros((), dtype=torch.float32)
    f_tot = h.new_zeros((), dtype=torch.float32)
    gold_v = []
    for t0 in range(0, S, chunk):
        ll = labels[:, t0:t0 + chunk]
        text = T.unembed(params, h[:, t0:t0 + chunk], cfg).float()
        gold_t = DL.gold_logit(text, ll)
        t_tot = t_tot + (DL.logsumexp(text) - gold_t).sum()
        fused = 0.5 * (text + vision[:, None, :])
        gold_f = DL.gold_logit(fused, ll)
        f_tot = f_tot + (DL.logsumexp(fused) - gold_f).sum()
        if DL.is_dtensor(vision):
            # a vocab-split head's gold logits a chunk's [B, c, V] at a time
            gold_v.append(DL.gold_logit(
                vision[:, None, :].expand(-1, ll.shape[1], -1), ll))
    n = B * S
    # the vision CE broadcast over the positions: its lse is constant per
    # sequence, the gold logit follows each position's label
    gold_v = (torch.cat(gold_v, dim=1) if gold_v
              else torch.gather(vision, -1, labels.long()))
    g_vision = (v_lse[:, None] - gold_v).mean()
    return t_tot / n + f_tot / n + g_vision, aux
