"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12
FP8_FLOPS = 1979e12
INT8_OPS = 1979e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
MEMORY_BYTES = 80e9
