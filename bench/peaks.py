"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity; at the full 700 W power limit).  The benchmark's own copy:
rooflines and model-FLOP shares are taken against these numbers."""

BF16_FLOPS = 989e12        # FLOP/s, bf16 and fp16 on the tensor cores
HBM_BYTES = 3.35e12        # B/s, HBM3
