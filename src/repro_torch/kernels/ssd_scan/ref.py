"""Plain PyTorch version of the SSD scan: the sequential SSM recurrence (the
'linear form' of SSD), in fp32.

Counterpart of ``repro/kernels/ssd_scan/ref.py::ssd_scan_ref``. Unlike that
oracle it also returns the final state, which the serve path keeps for
decode, and it takes B and C either per (batch, head) row or once per batch
row shared by ``heads_per_bc`` consecutive heads (mamba2 has one B/C group).
"""
from __future__ import annotations

import torch


def ssd_scan_ref(x, bmat, cmat, dt, da, *, heads_per_bc: int = 1):
    """x: [BH,S,P]; bmat/cmat: [BH/heads_per_bc,S,N] (row ``bh`` reads B/C
    row ``bh // heads_per_bc``); dt/da: [BH,S,1] or [BH,S] (da = dt * a <= 0).

    h_t = exp(da_t) h_{t-1} + dt_t x_t B_t^T ;  y_t = h_t C_t ;  h_0 = 0.
    Returns (y [BH,S,P] in x's dtype, h_S [BH,P,N] in fp32)."""
    bh, s, p = x.shape
    n = bmat.shape[-1]
    g = heads_per_bc
    rows = bh // g
    xf = x.float().reshape(rows, g, s, p)
    bf, cf = bmat.float(), cmat.float()                  # [rows,S,N]
    dtf = dt.float().reshape(rows, g, s)
    daf = da.float().reshape(rows, g, s)
    h = torch.zeros((rows, g, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        h = torch.exp(daf[..., t])[..., None, None] * h \
            + (dtf[..., t, None] * xf[:, :, t])[..., :, None] \
            * bf[:, None, t, None, :]                     # [rows,g,P,N]
        ys.append((h * cf[:, None, t, None, :]).sum(-1))   # [rows,g,P]
    y = torch.stack(ys, dim=2).reshape(bh, s, p)
    return y.to(x.dtype), h.reshape(bh, p, n)
