"""Plain PyTorch versions of the cross-entropy terms of the chunked LM-head
loss and of their backward, in fp32.

The forward is the chain of the reference's ``chunked_xent``
(``repro/models/transformer.py``: the logits cast to fp32, their
logsumexp, the label's logit) and of the port's before the kernels; the
reference has no backward of its own (XLA differentiates the chain):
:func:`cross_entropy_bwd_ref` is the function that gradient computes.
"""
from __future__ import annotations

import torch


def cross_entropy_ref(logits: torch.Tensor, labels: torch.Tensor):
    """(lse, gold), each [...] fp32, of logits [..., V] at labels [...]:
    the logsumexp over V and the logit at the label."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse, gold


def cross_entropy_bwd_ref(logits: torch.Tensor, labels: torch.Tensor,
                          lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient [..., V], in the logits' dtype, of ``lse - gold`` for
    its gradient ``g`` ([...], or one value): g (exp(logits - lse) -
    onehot(labels)), in fp32."""
    lf = logits.float()
    onehot = torch.zeros_like(lf).scatter_(-1, labels[..., None].long(), 1.0)
    p = torch.exp(lf - lse[..., None])
    return (g.float()[..., None] * (p - onehot)).to(logits.dtype)
