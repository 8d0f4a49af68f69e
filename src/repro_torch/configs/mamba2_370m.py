"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", arch_type="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    source="[arXiv:2405.21060] Mamba2 SSD",
)
