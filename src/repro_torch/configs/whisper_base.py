"""whisper-base [audio] — encoder-decoder; mel+conv frontend STUBBED to frame
embeddings (carve-out). [arXiv:2212.04356]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", arch_type="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    is_encoder_decoder=True, encoder_layers=6,
    modalities=("audio", "text"),
    source="[arXiv:2212.04356] Whisper",
)
