"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet,
dense rates, no sparsity), at its full 700 W power limit. A card held
below that limit runs slower under load; the run records the limit it
found beside every share of these peaks.

K3's integer adds run on the CUDA cores; its share is bound by bytes at
every size the benchmark drives, so the integer peak is not needed.
"""

BF16_FLOPS = 989.4e12        # dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12    # HBM3 bandwidth
