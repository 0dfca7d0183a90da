"""Global-norm gradient clipping, as the reference's
``repro/optim/clipping.py``. Gradients are a dict of tensors (the port's
per-layer tensors; the reference's layer-stacked leaves sum the same
squares, in another order)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32."""
    sums = [torch.sum(torch.square(g.float())) for g in grads.values()]
    return torch.sqrt(torch.stack(sums).sum())


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float = 1.0
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), norm), each in its dtype."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, norm
