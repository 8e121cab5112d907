"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A roofline share is stated
against these, with the card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores: the port's products keep TF32 off
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES = 80e9
