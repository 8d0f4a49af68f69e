"""Input and decode-cache shapes for every (arch x input-shape) pair, and
their partition specs: the counterpart of the JAX package's
``launch/specs.py``.

Shapes are meta tensors (no memory) in place of ``ShapeDtypeStruct``;
``launch/dryrun.py`` lays them out as DTensors of fake tensors.  Specs are
the port's tuple ``P`` (``launch/sharding.py``), applied to the trailing
dims of a leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..models import encdec, transformer as T
from ..models.config import ModelConfig
from .mesh import axis_sizes, data_axes
from .sharding import P, _map_with_path, _path_str, sanitize_tree


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k":   InputShape("long_500k", 524288, 1, "decode"),
}

# whisper's encoder source length (30 s of 10 ms frames, post-conv: 1500)
WHISPER_SRC_LEN = 1536
# llava anyres tiling: 4 tiles + base image, 576 patches each
VLM_N_PATCHES = 2880

# archs with full quadratic attention and no sub-quadratic variant skip
# long_500k; gemma3 (sliding window), jamba and mamba2 (SSM state) run it
LONG_CONTEXT_OK = {"gemma3-12b", "jamba-v0.1-52b", "mamba2-370m"}


def supports(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        return False, ("full quadratic attention; no sub-quadratic variant "
                       "implemented for this family")
    return True, ""


def batch_axes(mesh):
    """The data axes as one spec entry: a bare name when there is one
    (``P("data")`` and ``P(("data",))`` shard alike, and the JAX package's
    ``PartitionSpec`` stores the bare name), else the tuple."""
    da = data_axes(mesh)
    return da[0] if len(da) == 1 else da


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta tensors of the step inputs (not params, optimizer or cache)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = _meta((B, S), torch.int32)
        if cfg.arch_type == "vlm":
            batch["patches"] = _meta((B, VLM_N_PATCHES, cfg.frontend_dims[0]),
                                     torch.bfloat16)
        if cfg.arch_type == "audio":
            batch["src_embeds"] = _meta((B, WHISPER_SRC_LEN, cfg.d_model),
                                        torch.bfloat16)
        return batch
    # decode: one new token against a seq_len cache
    return {"token": _meta((B, 1), torch.int32),
            "index": _meta((), torch.int32)}


def batch_pspecs(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    da = batch_axes(mesh)
    bspec = da if shape.global_batch > 1 else None
    if shape.kind in ("train", "prefill"):
        out = {"tokens": P(bspec, None)}
        if shape.kind == "train":
            out["labels"] = P(bspec, None)
        if cfg.arch_type == "vlm":
            out["patches"] = P(bspec, None, None)
        if cfg.arch_type == "audio":
            out["src_embeds"] = P(bspec, None, None)
        return out
    return {"token": P(bspec, None), "index": P()}


# ---------------------------------------------------------------------------
def cache_specs(cfg: ModelConfig, shape: InputShape):
    """The decode cache as meta tensors (``init_cache``'s tree)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.arch_type == "audio":
        return encdec.init_dec_cache(cfg, B, S, WHISPER_SRC_LEN,
                                     device="meta")
    return T.init_cache(cfg, B, S, device="meta")


def cache_pspecs(cache_shape, cfg: ModelConfig, shape: InputShape, mesh):
    """KV caches: batch over data when B>1; kv-heads over model when they
    divide it, otherwise the sequence dim takes the model axis (all the
    configs have GQA kv=8 < 16, so seq-sharded caches are the norm).
    long_500k (B=1) also spreads seq over the data axes."""
    da = batch_axes(mesh)
    batch_first = shape.global_batch > 1
    n_model = axis_sizes(mesh)["model"]
    kv_div = cfg.n_kv_heads > 0 and cfg.n_kv_heads % n_model == 0

    def spec_for(path: str, leaf) -> P:
        nd = leaf.dim()
        if path.endswith(("/k", "/v")) or "cross_" in path:
            # [n_blocks(?), B, S, K, hd]
            if kv_div:
                s = (None, da if batch_first else None,
                     None if batch_first else da, "model", None)
            elif batch_first:
                s = (None, da, "model", None, None)
            else:
                s = (None, None, data_axes(mesh) + ("model",), None, None)
            return P(*s[-nd:]) if nd <= 5 else P(*((None,) * (nd - 5) + s))
        if path.endswith("/ssm"):
            # [n_blocks, B, nh, N, hp]
            s = (None, da if batch_first else None, "model", None, None)
            return P(*s[-nd:])
        if "conv_x" in path:
            s = (None, da if batch_first else None, None, "model")
            return P(*s[-nd:])
        if "conv_" in path:
            s = (None, da if batch_first else None, None, None)
            return P(*s[-nd:])
        return P(*((None,) * nd))

    specs = _map_with_path(lambda path, leaf: spec_for(_path_str(path), leaf),
                           cache_shape)
    return sanitize_tree(specs, cache_shape, mesh)
