"""Launcher of the CUDA decode attention (``csrc/decode_attention.cu``).

Replaces the TPU kernel ``repro/kernels/decode_attention/kernel.py``
(``_dec_kernel`` / ``decode_attention_fwd``); the source note in the ``.cu``
file says what bounds it on the card and how its split-KV design answers
that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library

MIN_CHUNK = 64     # cache positions per split, at the most splits


def num_splits(device: torch.device, batch: int, hkv: int, smax: int) -> int:
    """Splits of the cache: about two blocks per SM over all (batch, KV head)
    pairs, but no split shorter than MIN_CHUNK positions of a full cache.
    Chosen from shapes only, so the launch needs no host sync on kv_len."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-2 * sms // max(1, batch * hkv))
    return max(1, min(want, -(-smax // MIN_CHUNK)))


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """q: [B,1,Hq,dh]; k/v: [B,Smax,Hkv,dh]; kv_len: int32 [1] on the same
    card (read by the kernel, so no host sync). Contiguous, one dtype
    (fp32 or bf16), dh <= 256."""
    library.require_cuda("decode_attention", q, k, v, kv_len)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in library.DTYPE_CODES:
        raise TypeError(f"decode_attention: q/k/v must share dtype float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if kv_len.dtype != torch.int32 or kv_len.numel() != 1:
        raise TypeError("decode_attention: kv_len must be one int32 value")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("decode_attention: expected q [B,1,Hq,dh], k/v "
                         "[B,Smax,Hkv,dh]")
    b, _, hq, dh = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or hq % hkv or dh > 256:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    scale = dh ** -0.5
    lib = library.library()
    nsplit = num_splits(q.device, b, hkv, smax)
    scratch = torch.empty(
        lib.decode_attention_scratch_floats(b, hq, dh, nsplit),
        dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        library.launch("decode_attention_launch", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                       scratch.data_ptr(), b, smax, hq, hkv, dh, nsplit,
                       float(scale), library.DTYPE_CODES[q.dtype],
                       library.stream_of(q))
    decode_attention_fwd.launches += 1
    return out


decode_attention_fwd.launches = 0
