"""Model configuration and layer-pattern derivation.

The port's own copy of the JAX package's ``models/config.py``: one
``ModelConfig`` covers every architecture family of the registry
(``configs/``: dense / moe / hybrid / ssm / vlm / audio) and the FL encoder
presets, with the same fields in the same order, the derived ``hd``,
``d_inner``, ``ssm_n_heads``, ``block_pattern`` and ``n_blocks``, and
``reduced`` for the small CPU variants.  The layer stack is ``n_blocks``
repetitions of a super-block (``block_pattern``); uniform architectures
use a block of size 1.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside a super-block."""
    kind: str = "attn"              # "attn" | "mamba"
    window: Optional[int] = None    # sliding-window size (None = full/causal)
    moe: bool = False               # MoE MLP instead of dense MLP


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # --- attention flavour ---
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None    # window for "local" layers
    local_global_ratio: int = 0             # N local + 1 global per block
    rope_theta: float = 10000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # MoE on layers with i % moe_every == moe_every-1
    expert_d_ff: Optional[int] = None       # per-expert d_ff != dense d_ff
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    attn_every: int = 0         # hybrid: one attn layer per `attn_every`
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    # --- multimodal (decision-level fusion) ---
    modalities: Tuple[str, ...] = ("text",)
    frontend_dims: Tuple[int, ...] = ()     # stub embedding dims per extra modality
    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # --- misc ---
    tie_embeddings: bool = False
    source: str = ""            # citation (paper / model card)

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.n_heads)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # ------------------------------------------------------------------
    def block_pattern(self) -> Tuple[LayerSpec, ...]:
        """The repeating super-block, from the config knobs."""
        if self.arch_type == "ssm":
            return (LayerSpec(kind="mamba"),)
        if self.attn_every > 0:  # hybrid: 1 attn + (attn_every-1) mamba
            return tuple(
                LayerSpec(kind="attn" if i == 0 else "mamba",
                          moe=self.n_experts > 0
                          and i % self.moe_every == self.moe_every - 1)
                for i in range(self.attn_every))
        if self.local_global_ratio > 0:  # N local then 1 global
            local = [LayerSpec(kind="attn", window=self.sliding_window)
                     for _ in range(self.local_global_ratio)]
            return tuple(local + [LayerSpec(kind="attn", window=None)])
        return (LayerSpec(kind="attn", window=self.sliding_window,
                          moe=self.n_experts > 0),)

    @property
    def n_blocks(self) -> int:
        bp = len(self.block_pattern())
        if self.n_layers % bp:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not "
                             f"divisible by super-block size {bp}")
        return self.n_layers // bp

    def reduced(self, **overrides) -> "ModelConfig":
        """A CPU-smoke-test variant of the same family (2 blocks, tiny
        dims), field for field the JAX package's."""
        bp = len(self.block_pattern())
        small = dict(
            n_layers=min(self.n_layers, 2 * bp),
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            expert_d_ff=(min(self.expert_d_ff, 128) if self.expert_d_ff
                         else None),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else None),
            encoder_layers=(min(self.encoder_layers, 2)
                            if self.encoder_layers else 0),
            frontend_dims=tuple(min(d, 128) for d in self.frontend_dims),
            dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# unimodal encoder presets for the FL backbone adapter (fl/client.py)
# ---------------------------------------------------------------------------
#: backbone architectures the FL harness can train: "lstm-cnn" is the
#: paper's submodel pair (models/paper_models.py); the rest map each
#: modality's feature stack through a small encoder built from the blocks
#: above (models/multimodal.py::encoder_apply)
ENCODER_ARCHS = ("transformer", "ssd")
FL_ARCHS = ("lstm-cnn",) + ENCODER_ARCHS

#: per-arch encoder stacks sized for federated clients: f32, 2 blocks,
#: d_model 32.  ``ssm_chunk=8`` divides every dataset's feature time axis
#: (audio T=32, text T=24, image rows T=32 — data/scenarios.py), the
#: ``ssd_chunked`` contract.
ENCODER_PRESETS = {
    "transformer": ModelConfig(
        name="fl-enc-transformer", arch_type="dense", n_layers=2,
        d_model=32, n_heads=4, n_kv_heads=4, head_dim=8, d_ff=64,
        vocab_size=0, dtype="float32"),
    "ssd": ModelConfig(
        name="fl-enc-ssd", arch_type="ssm", n_layers=2,
        d_model=32, n_heads=4, n_kv_heads=4, head_dim=8, d_ff=0,
        vocab_size=0, ssm_state=16, ssm_head_dim=8, ssm_expand=2,
        ssm_conv=4, ssm_chunk=8, dtype="float32"),
}


def encoder_config(arch: str) -> ModelConfig:
    """The ``ModelConfig`` behind one FL encoder architecture."""
    try:
        return ENCODER_PRESETS[arch]
    except KeyError:
        raise ValueError(f"unknown encoder arch {arch!r}; "
                         f"choose from {ENCODER_ARCHS}") from None
