"""Gradient compression with error feedback: int8 per-leaf symmetric
quantization, as the reference's ``repro/optim/compression.py``. The
quantization scale is the max over the reference's leaf, so over the group
of the port's per-layer tensors that ``interop.reference_leaves`` yields
(one scale for a layer-stacked leaf, not one per layer)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Grads = Dict[str, torch.Tensor]


def quantize_int8(gs: List[torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """int8 codes of every tensor of one leaf, and the leaf's scale."""
    amax = torch.stack([g.abs().max() for g in gs]).max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return [torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            for g in gs], scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads: Grads, error: Grads,
                   groups: Dict[str, List[Tuple[str, bool]]]
                   ) -> Tuple[Grads, Grads]:
    """(compressed-and-restored grads, new error feedback); ``groups`` are
    the reference's leaves (``interop.reference_leaves(params)``)."""
    newg, newe = {}, {}
    for members in groups.values():
        names = [n for n, _ in members]
        gf = [grads[n].float() + error[n] for n in names]
        qs, s = quantize_int8(gf)
        for n, f, q in zip(names, gf, qs):
            deq = dequantize_int8(q, s)
            newg[n] = deq.to(grads[n].dtype)
            newe[n] = f - deq
    return newg, newe


def init_error(params) -> Grads:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.named_parameters()}
