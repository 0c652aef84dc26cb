"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its full
700 W power limit; a card set below it reaches less, so every result line
carries the card's power limit beside the shares taken against these."""

BF16_FLOPS = 989e12
FP8_FLOPS = 1979e12
INT8_OPS = 1979e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
