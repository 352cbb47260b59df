"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, at the
card's full 700 W power limit). A card set below 700 W reaches less, so a
share of these peaks is given with the card's power limit beside it."""

BF16_FLOP_S = 989e12  # bf16 and fp16 tensor cores
TF32_FLOP_S = 495e12  # TF32 tensor cores
F32_FLOP_S = 67e12  # float32 outside the tensor cores
HBM_BYTES_S = 3.35e12
