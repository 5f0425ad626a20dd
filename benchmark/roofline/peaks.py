"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core
GPU datasheet, SXM5 column, dense rates without sparsity), at the card's
full 700 W power limit.  A run prints the card's own power limit beside
the numbers it reports against these."""

HBM_BYTES_PER_S = 3.35e12          # HBM3, 3.35 TB/s
PEAK_FLOPS = {
    "bfloat16": 989e12,            # tensor cores, bf16 / fp16 dense
    "float32": 67e12,              # CUDA cores, outside the tensor cores
}


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time for this work: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type
    (the same rule as ``chip_smoke.bound``, in seconds)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
