"""Dispatcher for decode attention: by the tensors' device.

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the plain PyTorch version. ``kv_len`` is one int32 value as
a tensor on q's device (the cache's ``idx`` plus one): the kernel reads it
there, so the call adds no host sync.
A meta tensor (the dry run's count) takes the CPU's route.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k, v, *, kv_len, window: int = 0, scale=None):
    """q: [B,1,Hq,DH]; k/v: [B,Smax,Hkv,DH]; kv_len: int32 tensor of one
    element. ``window > 0`` masks the positions below ``kv_len - window``
    (the reference's Pallas dispatcher drops the window; its oracle,
    ``sdpa_ref``, applies it, and so does the port). ``scale`` is the
    softmax scale (None: ``DH ** -0.5``)."""
    if q.device.type == "cuda":
        return decode_attention_fwd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), kv_len.reshape(1),
                                    window, scale=scale)
    if q.device.type not in ("cpu", "meta"):
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return decode_attention_ref(q, k, v, kv_len, window, scale=scale)
