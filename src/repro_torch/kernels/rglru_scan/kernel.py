"""Launcher of the CUDA RG-LRU scan (``csrc/rglru_scan.cu``).

Replaces the TPU kernel ``repro/kernels/rglru_scan/kernel.py``
(``_rglru_kernel`` / ``rglru_scan_fwd``); the source note in the ``.cu``
file says what bounds it on the card and how its design answers that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library


def rglru_scan_fwd(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """a, u: [B,S,C], contiguous CUDA tensors of one dtype (fp32 or bf16),
    computed in fp32. Returns h [B,S,C] in a's dtype, h_t = a_t h_{t-1} +
    u_t with h_0 = 0. Any B, S and C (no padding)."""
    library.refuse_grad("rglru_scan", a, u,
                        item=library.TRAINING_ITEM)
    library.require_cuda("rglru_scan", a, u)
    if a.dtype != u.dtype or a.dtype not in library.DTYPE_CODES:
        raise TypeError(f"rglru_scan: a and u must share dtype float32 or "
                        f"bfloat16, got {a.dtype}, {u.dtype}")
    if a.dim() != 3 or a.shape != u.shape:
        raise ValueError(f"rglru_scan: expected a, u [B,S,C] of one shape, "
                         f"got {tuple(a.shape)}, {tuple(u.shape)}")
    b, s, c = a.shape
    h = torch.empty_like(a)
    with torch.cuda.device(a.device):
        library.launch("rglru_scan_launch", a.data_ptr(), u.data_ptr(),
                       h.data_ptr(), b, s, c, library.DTYPE_CODES[a.dtype],
                       library.stream_of(a))
    rglru_scan_fwd.launches += 1
    return h


rglru_scan_fwd.launches = 0
