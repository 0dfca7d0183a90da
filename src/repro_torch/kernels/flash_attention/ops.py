"""Dispatcher for flash attention: by the tensors' device.

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the plain PyTorch version. The kernel takes any S and Skv
(tails are masked) and any dh up to 256 (no padding copy: it reads the
missing head dims as zeros), with the scale of the true dh.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,S,Hq,DH]; k/v: [B,Skv,Hkv,DH]."""
    if q.device.type == "cuda":
        return flash_attention_fwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_ref(q, k, v, causal=causal, window=window)
