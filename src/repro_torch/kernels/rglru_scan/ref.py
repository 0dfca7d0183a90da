"""Plain PyTorch version of the RG-LRU recurrence: the sequential scan, in
fp32.

Counterpart of ``repro/kernels/rglru_scan/ref.py::rglru_scan_ref`` (an
associative scan there; the same function up to summation order).
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """a, u: [B,S,C]; h_t = a_t h_{t-1} + u_t, h_0 = 0, computed in fp32.
    Returns h [B,S,C] in a's dtype."""
    af, uf = a.float(), u.float()
    h = torch.zeros_like(af[:, 0])
    out = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = af[:, t] * h + uf[:, t]
        out[:, t] = h
    return out.to(a.dtype)
