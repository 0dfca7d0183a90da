"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the full 700 W power limit): the yardstick of every
roofline and MFU share this benchmark reports.

fp32 operands are held against the TF32 tensor-core peak: no method that
keeps fp32 accuracy beats it, so a share of it cannot pass 100%.
"""
from __future__ import annotations

FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
         "float32": 495e12}
HBM_BYTES_PER_S = 3.35e12
MFU_PEAK = FLOPS["bfloat16"]


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the dtype's tensor-core peak and the bytes over HBM's."""
    return max(ops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
