"""Dispatcher for the RG-LRU scan: by the tensors' device.

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the plain PyTorch version. Any S and C: the kernel needs no
padding, unlike the reference's Pallas grid, which floor-divides both.
"""
from __future__ import annotations

from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def rglru_scan(a, u):
    """a, u: [B,S,C] -> h [B,S,C] in a's dtype (computed in fp32)."""
    if a.device.type == "cuda":
        return rglru_scan_fwd(a.contiguous(), u.contiguous())
    if a.device.type != "cpu":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    return rglru_scan_ref(a, u)
