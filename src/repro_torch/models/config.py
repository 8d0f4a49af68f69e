"""Model configuration for the FL encoder backbones.

The port's own copy of the parts of the JAX package's ``models/config.py``
that the encoders read: ``LayerSpec``, ``ModelConfig`` (the fields the
transformer and Mamba2 blocks use, with the derived ``hd``, ``d_inner``,
``ssm_n_heads``, ``block_pattern`` and ``n_blocks``), and the FL encoder
presets.  The layer stack is ``n_blocks`` repetitions of a super-block
(``block_pattern``); uniform architectures use a block of size 1.
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
    arch_type: str                  # dense|moe|hybrid|ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # --- attention flavour ---
    sliding_window: Optional[int] = None    # window for "local" layers
    local_global_ratio: int = 0             # N local + 1 global per block
    rope_theta: float = 10000.0
    # --- MoE ---
    n_experts: int = 0
    moe_every: int = 1
    # --- SSM / hybrid ---
    attn_every: int = 0         # hybrid: one attn layer per `attn_every`
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

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
