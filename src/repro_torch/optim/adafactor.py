"""Adafactor (Shazeer & Stern, 2018): factored second moment, no momentum;
the reference's ``repro/optim/adafactor.py``, statistic for statistic.

The reference keeps each per-layer parameter as one layer-stacked leaf
``[L, ...]``; the port keeps L tensors. Every statistic here is taken over
the reference's leaf, the group of same-named per-layer tensors that
``interop.reference_leaves`` yields, in the reference's layout (the port's
``nn.Linear`` weights transposed back to ``[in, out]``):
  - a leaf is factored when its last two dims are >= 2, so a stacked
    ``[L, d]`` leaf (a norm scale, a bias) is factored across its layers;
  - the update's RMS clip and its param-RMS ``scale`` are means over the
    whole stack for leaves below ``_STACK_MAP_MIN`` elements, and per layer
    above it (the reference maps its update over the layers there).
The state is keyed by the reference's leaf, in its layout: ``{"vr", "vc"}``
(``[..., rows]``, ``[..., cols]``) or ``{"v"}``.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from repro_torch.interop import is_stacked, reference_leaves

DECAY = 0.8
EPS1 = 1e-30
EPS2 = 1e-3
CLIP = 1.0
_STACK_MAP_MIN = 1 << 22


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def _ref_view(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    return t.T if transposed else t


def _leaf_shape(key: str, views: List[torch.Tensor]):
    return ((len(views),) if is_stacked(key) else ()) + tuple(views[0].shape)


def adafactor_init(params: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    named = dict(params.named_parameters())
    state = {}
    for key, members in reference_leaves(params).items():
        views = [_ref_view(named[n], t) for n, t in members]
        shape = _leaf_shape(key, views)
        dev = views[0].device
        if _factored(shape):
            state[key] = {
                "vr": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                "vc": torch.zeros(shape[:-2] + shape[-1:],
                                  dtype=torch.float32, device=dev)}
        else:
            state[key] = {"v": torch.zeros(shape, dtype=torch.float32,
                                           device=dev)}
    return state


def _update_one(p, g, s, beta, lr, gscale):
    """The reference's ``_update_one`` on one leaf (or one layer of it):
    (new params in p's dtype, new state)."""
    g = g.float() * gscale
    g2 = g * g + EPS1
    if _factored(p.shape):
        vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
        vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
        denom = (vr[..., None] * vc[..., None, :]
                 / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                               min=EPS1)[..., None])
        u = g * torch.rsqrt(torch.clamp(denom, min=EPS1))
        new_s = {"vr": vr, "vc": vc}
    else:
        v = beta * s["v"] + (1 - beta) * g2
        u = g * torch.rsqrt(torch.clamp(v, min=EPS1))
        new_s = {"v": v}
    rms = torch.sqrt(torch.mean(u * u) + EPS1)
    u = u / torch.clamp(rms / CLIP, min=1.0)
    pf = p.float()
    scale = torch.clamp(torch.sqrt(torch.mean(torch.square(pf))), min=EPS2)
    return (pf - lr * scale * u).to(p.dtype), new_s


@torch.no_grad()
def adafactor_update(params: nn.Module, grads: Dict[str, torch.Tensor],
                     state, step: torch.Tensor, lr, gscale=1.0):
    """One step at ``step`` (from 1). The params are written in place; the
    state's tensors are replaced. Returns (params, state, stats)."""
    stepf = step.to(torch.float32)
    beta = 1.0 - stepf ** (-DECAY)
    named = dict(params.named_parameters())
    new_state = {}
    for key, members in reference_leaves(params).items():
        ps = [_ref_view(named[n], t) for n, t in members]
        gs = [_ref_view(grads[n], t) for n, t in members]
        s = state[key]
        shape = _leaf_shape(key, ps)
        numel = ps[0].numel() * len(ps)
        if is_stacked(key) and len(shape) >= 3 and numel >= _STACK_MAP_MIN \
                and _factored(shape):
            # the reference maps these over the layers: every statistic is
            # the layer's own
            vr, vc = s["vr"].clone(), s["vc"].clone()
            for i, (p, g) in enumerate(zip(ps, gs)):
                newp, ns = _update_one(p, g, {"vr": vr[i], "vc": vc[i]},
                                       beta, lr, gscale)
                p.copy_(newp)
                vr[i], vc[i] = ns["vr"], ns["vc"]
            new_state[key] = {"vr": vr, "vc": vc}
            continue
        if is_stacked(key):
            newp, new_state[key] = _update_one(torch.stack(ps),
                                               torch.stack(gs), s, beta, lr,
                                               gscale)
            for p, q in zip(ps, newp):
                p.copy_(q)
        else:
            newp, new_state[key] = _update_one(ps[0], gs[0], s, beta, lr,
                                               gscale)
            ps[0].copy_(newp)
    return params, new_state, {}
