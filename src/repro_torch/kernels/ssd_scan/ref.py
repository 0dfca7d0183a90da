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


def ssd_scan_bwd_ref(x, bmat, cmat, dt, da, dy, dstate=None, *,
                     heads_per_bc: int = 1):
    """The gradients (dx, dB, dC, ddt, dda) of :func:`ssd_scan_ref` for the
    output gradient ``dy`` [BH,S,P] and, optionally, the final state's
    gradient ``dstate`` [BH,P,N] (0 when None): the reverse sequential
    recurrence in fp32, from every state h_t the forward recurrence passes
    through (kept, S x BH x P x N floats). With G_t the gradient of h_t,

      G_t = dy_t C_t^T + exp(da_{t+1}) G_{t+1},  G_{S-1} = dy C^T + dstate,
      dx_t = dt_t G_t B_t,  dB_t = dt_t G_t^T x_t,  ddt_t = x_t^T G_t B_t,
      dda_t = exp(da_t) <G_t, h_{t-1}>,  dC_t = h_t^T dy_t,

    dB and dC summed over the ``heads_per_bc`` heads that share a B/C row.
    Each gradient is returned in its input's dtype and shape."""
    bh, s, p = x.shape
    n = bmat.shape[-1]
    g = heads_per_bc
    rows = bh // g
    xf = x.float().reshape(rows, g, s, p)
    dyf = dy.float().reshape(rows, g, s, p)
    bf, cf = bmat.float(), cmat.float()                  # [rows,S,N]
    dtf = dt.float().reshape(rows, g, s)
    daf = da.float().reshape(rows, g, s)
    h = torch.zeros((rows, g, p, n), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(s):
        h = torch.exp(daf[..., t])[..., None, None] * h \
            + (dtf[..., t, None] * xf[:, :, t])[..., :, None] \
            * bf[:, None, t, None, :]
        hs.append(h)
    G = torch.zeros_like(h) if dstate is None else \
        dstate.float().reshape(rows, g, p, n).clone()
    dx, ddt, dda = torch.empty_like(xf), torch.empty_like(dtf), \
        torch.empty_like(daf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    for t in range(s - 1, -1, -1):
        G = G + dyf[:, :, t, :, None] * cf[:, None, t, None, :]
        dc[:, t] = (hs[t] * dyf[:, :, t, :, None]).sum(-2).sum(1)
        inner = (G * bf[:, None, t, None, :]).sum(-1)          # [rows,g,P]
        dx[:, :, t] = dtf[..., t, None] * inner
        ddt[..., t] = (xf[:, :, t] * inner).sum(-1)
        db[:, t] = (dtf[..., t, None] * (G * xf[:, :, t, :, None]).sum(-2)
                    ).sum(1)
        decay = torch.exp(daf[..., t])
        if t > 0:
            dda[..., t] = decay * (G * hs[t - 1]).sum((-1, -2))
        else:
            dda[..., t] = 0.0
        G = decay[..., None, None] * G
    return (dx.reshape(bh, s, p).to(x.dtype), db.to(bmat.dtype),
            dc.to(cmat.dtype), ddt.reshape(dt.shape).to(dt.dtype),
            dda.reshape(da.shape).to(da.dtype))
