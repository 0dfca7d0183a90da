"""Dispatcher for flash attention: by the tensors' device.

A CUDA tensor goes to the hand-written kernels (or the call raises); a CPU
tensor goes to the plain PyTorch version, which plain autograd
differentiates. On the card, a call that needs a gradient (grad enabled and
an input that requires grad) goes through :class:`FlashAttentionFn`, whose
forward is the forward kernel with its row log-sum-exp and whose backward
is the backward kernel; any other call launches the forward alone. The
kernels take any S and Skv (tails are masked) and any dh up to 256, with
the scale of the true dh.
A meta tensor (the dry run's count) takes the CPU's route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


class FlashAttentionFn(torch.autograd.Function):
    """Attention whose forward and backward are the CUDA kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,S,Hq,DH]; k/v: [B,Skv,Hkv,DH]."""
    if q.device.type == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v, bool(causal), int(window))
        return flash_attention_fwd(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cpu", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_ref(q, k, v, causal=causal, window=window)
