"""Dispatcher for the RG-LRU scan: by the tensors' device.

A CUDA tensor goes to the hand-written kernels (or the call raises); a CPU
tensor goes to the plain PyTorch version, which plain autograd
differentiates (``ref.rglru_scan_bwd_ref`` is the plain backward that the
backward kernel is held against). On the card, a call that needs a gradient (grad enabled and
an input that requires grad) goes through :class:`RGLRUScanFn`, whose
forward is the forward kernel and whose backward is the backward kernel;
any other call launches the forward alone. Any S and C: the kernels need no
padding, unlike the reference's Pallas grid, which floor-divides both.
A meta tensor (the dry run's count) takes the CPU's route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.kernel import rglru_scan_bwd, rglru_scan_fwd
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


class RGLRUScanFn(torch.autograd.Function):
    """The scan with a backward on CUDA tensors: the two kernels. It saves
    a and the output h (h_{t-1} enters da)."""

    @staticmethod
    def forward(ctx, a, u):
        h = rglru_scan_fwd(a, u)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h, g.to(a.dtype).contiguous())


def rglru_scan(a, u):
    """a, u: [B,S,C] -> h [B,S,C] in a's dtype (computed in fp32)."""
    if a.device.type == "cuda":
        a, u = a.contiguous(), u.contiguous()
        if torch.is_grad_enabled() and (a.requires_grad or u.requires_grad):
            return RGLRUScanFn.apply(a, u)
        return rglru_scan_fwd(a, u)
    if a.device.type not in ("cpu", "meta"):
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    return rglru_scan_ref(a, u)
