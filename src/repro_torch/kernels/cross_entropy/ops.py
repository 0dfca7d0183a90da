"""Dispatcher for the cross-entropy terms of the chunked LM-head loss: by
the logits' device.

A CUDA tensor goes to the hand-written kernels (or the call raises); a CPU
or meta tensor (the dry run's count) to the plain PyTorch version, which
plain autograd differentiates (``ref.cross_entropy_bwd_ref`` is the plain
backward the backward kernel is held against). On the card, a call that
needs a gradient goes through :class:`CrossEntropyFn`, whose forward is the
forward kernel and whose backward the backward kernel; any other call
launches the forward alone. A DTensor's logits (a vocabulary split over a
mesh) do not come here: ``models.transformer`` joins their slices' terms
itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cross_entropy.kernel import (cross_entropy_bwd,
                                                      cross_entropy_fwd)
from repro_torch.kernels.cross_entropy.ref import cross_entropy_ref


class CrossEntropyFn(torch.autograd.Function):
    """The rows' loss ``lse - gold`` with a backward on CUDA tensors: the
    two kernels. It saves the logits, the labels and lse; under the loss
    chunk's checkpoint the logits it saves are not kept between the
    forward and the backward but recomputed, as the chain's were."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse, gold = cross_entropy_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return cross_entropy_bwd(logits, labels, lse, g), None


def cross_entropy(logits, labels):
    """logits [..., V], labels [...] -> the loss of each position [...],
    fp32: logsumexp(logits) minus the logit at the label, computed in
    fp32."""
    if logits.device.type == "cuda":
        return by_rows(logits, labels)
    if logits.device.type not in ("cpu", "meta"):
        raise ValueError(f"cross_entropy: unsupported device {logits.device}")
    lse, gold = cross_entropy_ref(logits, labels)
    return lse - gold


def by_rows(logits, labels):
    """The kernels' route of :func:`cross_entropy`: the logits as
    contiguous rows [R,V], the labels as [R], through
    :class:`CrossEntropyFn` when a gradient is needed."""
    shape, v = labels.shape, logits.shape[-1]
    rows = logits.reshape(-1, v).contiguous()
    lab = labels.reshape(-1).contiguous()
    if torch.is_grad_enabled() and rows.requires_grad:
        return CrossEntropyFn.apply(rows, lab).reshape(shape)
    lse, gold = cross_entropy_fwd(rows, lab)
    return (lse - gold).reshape(shape)
