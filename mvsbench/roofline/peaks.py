"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): the yardstick of every roofline share and of the MFU."""

BYTES_PER_S = 3.35e12  # HBM3
BF16_FLOPS = 989e12  # tensor cores, dense
TF32_FLOPS = 495e12  # tensor cores, dense
FP32_FLOPS = 67e12  # CUDA cores
