"""Plain PyTorch versions of the RG-LRU recurrence and its backward: the
sequential scans, in fp32.

Counterpart of ``repro/kernels/rglru_scan/ref.py::rglru_scan_ref`` (an
associative scan there; the same function up to summation order). The
reference has no backward of its own: XLA differentiates its associative
scan; :func:`rglru_scan_bwd_ref` is the function that gradient computes.
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


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """The gradients (da, du) [B,S,C] in a's dtype of the scan whose output
    was ``h``, for the output gradient ``g``: the reverse recurrence e_t =
    g_t + a_{t+1} e_{t+1} (e_S = 0 past the end) in fp32, then du_t = e_t
    and da_t = e_t h_{t-1} (h_{-1} = 0)."""
    af, hf, gf = a.float(), h.float(), g.float()
    s = a.shape[1]
    e = torch.zeros_like(af[:, 0])
    du = torch.empty_like(af)
    for t in range(s - 1, -1, -1):
        nxt = af[:, t + 1] if t + 1 < s else torch.zeros_like(e)
        e = gf[:, t] + nxt * e
        du[:, t] = e
    hprev = torch.cat([torch.zeros_like(hf[:, :1]), hf[:, :-1]], dim=1)
    return (du * hprev).to(a.dtype), du.to(a.dtype)
