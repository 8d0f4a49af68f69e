"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family; 12B sizing per Gemma 3 tech report]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", arch_type="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144,
    qk_norm=True, sliding_window=1024, local_global_ratio=5,
    rope_theta=1_000_000.0,
    source="[hf:google/gemma-3-1b-pt]; Gemma 3 technical report",
)
