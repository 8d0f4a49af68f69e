"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2 on
every other layer. [arXiv:2403.19887]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", arch_type="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    n_experts=16, top_k=2, expert_d_ff=14336, moe_every=2,
    attn_every=8, ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    source="[arXiv:2403.19887] Jamba v0.1",
)
