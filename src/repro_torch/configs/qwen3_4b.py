"""qwen3-4b [dense] — qk_norm, GQA kv=8. [hf:Qwen/Qwen3-8B family]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", arch_type="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936,
    qk_norm=True,
    source="[hf:Qwen/Qwen3-8B family card]",
)
