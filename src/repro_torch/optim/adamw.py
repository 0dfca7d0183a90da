"""AdamW with fp32 moments, the reference's formula
(``repro/optim/adamw.py``, ``_update_one``): eps added to sqrt(v_hat), the
weight decay added to the update before the lr scales it. Not
``torch.optim.AdamW``, which places both differently.

Elementwise, so the port's per-layer tensors give the reference's result
for its layer-stacked leaves. Runs under ``torch.no_grad()`` with in-place
``_foreach_`` ops: the moments are updated in place and so are the params
(the reference returns new arrays); fp32 params are updated in place, others
through an fp32 copy cast back.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1


def adamw_init(params: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.named_parameters()}
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()}}


@torch.no_grad()
def adamw_update(params: nn.Module, grads: Dict[str, torch.Tensor], state,
                 step: torch.Tensor, lr, gscale=1.0):
    """One step at ``step`` (the count after this update, from 1). Returns
    (params, state, stats), both updated in place."""
    names = list(grads)
    named = dict(params.named_parameters())
    ps = [named[n] for n in names]
    m = [state["m"][n] for n in names]
    v = [state["v"][n] for n in names]
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(B1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(B2, device=stepf.device), stepf)
    gscale = torch.as_tensor(gscale, dtype=torch.float32, device=ps[0].device)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=ps[0].device)
    g = torch._foreach_mul([grads[n].float() for n in names], gscale)
    torch._foreach_mul_(m, B1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - B1))
    torch._foreach_mul_(v, B2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - B2),
                                              g))
    del g
    u = torch._foreach_div(m, bc1.to(ps[0].device))
    den = torch._foreach_div(v, bc2.to(ps[0].device))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, EPS)
    torch._foreach_div_(u, den)
    del den
    pf = [p.float() for p in ps]     # the params themselves when fp32
    torch._foreach_add_(u, torch._foreach_mul(pf, WD))
    torch._foreach_mul_(u, lr)
    torch._foreach_sub_(pf, u)
    for p, f in zip(ps, pf):
        if f is not p:
            p.copy_(f)
    return params, state, {}
