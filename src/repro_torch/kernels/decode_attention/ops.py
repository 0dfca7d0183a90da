"""Dispatcher for decode attention: by the tensors' device.

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the plain PyTorch version. ``kv_len`` is one int32 value as
a tensor on q's device (the cache's ``idx`` plus one): the kernel reads it
there, so the call adds no host sync.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k, v, *, kv_len):
    """q: [B,1,Hq,DH]; k/v: [B,Smax,Hkv,DH]; kv_len: int32 tensor of one
    element."""
    if q.device.type == "cuda":
        return decode_attention_fwd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), kv_len.reshape(1))
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return decode_attention_ref(q, k, v, kv_len)
