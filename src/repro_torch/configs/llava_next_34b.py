"""llava-next-34b [vlm] — anyres tiling; vision frontend STUBBED to patch
embeddings (carve-out), decision-level fusion head per the paper.
[hf:llava-hf/llava-v1.6-mistral-7b-hf family, 34B sizing]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", arch_type="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    modalities=("text", "vision"), frontend_dims=(1024,),
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf] (34B sizing)",
)
