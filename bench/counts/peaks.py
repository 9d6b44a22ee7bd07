"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, no
sparsity, at its 700 W limit)."""

BF16_FLOPS = 989e12        # bf16 / fp16 tensor cores
TF32_FLOPS = 495e12        # TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12
