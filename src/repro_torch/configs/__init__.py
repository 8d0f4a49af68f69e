"""Architecture registry: --arch <id> resolves here.  The ten\nconfigurations are copies of the JAX package's, value for value."""
from . import (gemma3_12b, jamba_v01_52b, kimi_k2_1t_a32b,
               llama4_scout_17b_a16e, llava_next_34b, mamba2_370m,
               qwen2_72b, qwen3_0_6b, qwen3_4b, whisper_base)

ARCHS = {
    "gemma3-12b": gemma3_12b.CONFIG,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b.CONFIG,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e.CONFIG,
    "jamba-v0.1-52b": jamba_v01_52b.CONFIG,
    "llava-next-34b": llava_next_34b.CONFIG,
    "qwen2-72b": qwen2_72b.CONFIG,
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "mamba2-370m": mamba2_370m.CONFIG,
    "whisper-base": whisper_base.CONFIG,
    "qwen3-4b": qwen3_4b.CONFIG,
}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
