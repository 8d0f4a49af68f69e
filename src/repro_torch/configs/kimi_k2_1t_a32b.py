"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 + 1 shared.
[arXiv:2501.kimi2 paper-table]. Assigned spec: GQA kv=8, per-expert d_ff=2048."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", arch_type="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840,
    n_experts=384, top_k=8, expert_d_ff=2048, n_shared_experts=1,
    source="[arXiv:2501.kimi2] Kimi K2 paper table",
)
