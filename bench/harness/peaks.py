"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity; at the full 700 W power limit)."""

#: float32 outside the tensor cores [FLOP/s]
F32_FLOPS = 67e12
#: TF32 on the tensor cores [FLOP/s]
TF32_FLOPS = 495e12
#: bfloat16 / float16 on the tensor cores [FLOP/s]
BF16_FLOPS = 989e12
#: HBM3 bandwidth [B/s]
HBM_BYTES_PER_S = 3.35e12
#: device memory [B]
MEMORY_BYTES = 80e9
