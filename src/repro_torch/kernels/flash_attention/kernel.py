"""Launcher of the CUDA flash-attention forward (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``_fa_kernel`` / ``flash_attention_fwd``); the source note in the ``.cu``
file says what bounds it on the card and how its design answers that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,S,Hq,dh]; k/v: [B,Skv,Hkv,dh]; contiguous CUDA tensors of one
    dtype (fp32 or bf16), dh <= 256. The kernel runs at the next width of
    64/128/256 and reads the missing head dims as zeros; the scale is the
    true ``dh ** -0.5``."""
    library.require_cuda("flash_attention", q, k, v)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in library.DTYPE_CODES:
        raise TypeError(f"flash_attention: q/k/v must share dtype float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: expected q [B,S,Hq,dh], k/v "
                         "[B,Skv,Hkv,dh]")
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or hq % hkv or dh > 256:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    scale = dh ** -0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        library.launch("flash_attention_launch", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), b, sq, skv, hq, hkv, dh,
                       int(bool(causal)), int(window), float(scale),
                       library.DTYPE_CODES[q.dtype], library.stream_of(q))
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
