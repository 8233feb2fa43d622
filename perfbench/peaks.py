"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BYTES_PER_S = 3.35e12  # HBM3
FLOPS = {
    "bfloat16": 989e12,  # tensor cores
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,  # outside the tensor cores
}
