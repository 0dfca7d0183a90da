"""Launcher of the CUDA decode attention (``csrc/decode_attention.cu``).

Replaces the TPU kernel ``repro/kernels/decode_attention/kernel.py``
(``_dec_kernel`` / ``decode_attention_fwd``); the source note in the ``.cu``
file says what bounds it on the card and how its split-KV design answers
that.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import library

CLUSTER = 8        # blocks merged through distributed shared memory
MIN_CHUNK = 8      # cache positions per split, at the most splits
MAX_SPLITS = 256   # 32 clusters: the kernel's last merge holds 32 partials


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (looked up once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def num_splits(sms: int, batch: int, hkv: int, smax: int) -> int:
    """Splits of the cache per (batch, KV head): about one block per SM over
    all (batch, KV head) pairs, in whole clusters of CLUSTER blocks, but no
    split shorter than MIN_CHUNK positions of a full cache (beyond one
    cluster) and at most MAX_SPLITS. Chosen from shapes only, so the launch needs no host sync on
    kv_len."""
    want = -(-sms // max(1, batch * hkv))
    want = -(-want // CLUSTER) * CLUSTER
    cap = max(CLUSTER, smax // MIN_CHUNK // CLUSTER * CLUSTER)
    return min(want, cap, MAX_SPLITS)


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def arrival_counters(device: torch.device, stream: int, rows: int
                     ) -> torch.Tensor:
    """The kernel's arrival counters (int32, zeroed; the kernel leaves them
    zeroed), one buffer per (device, stream), so that calls that may run at
    once never share one. Grows when a call has more rows."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < rows:
        buf = torch.zeros(max(rows, 64), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor, window: int = 0
                         ) -> torch.Tensor:
    """q: [B,1,Hq,dh]; k/v: [B,Smax,Hkv,dh]; kv_len: int32 [1] on the same
    card (read by the kernel, so no host sync). Contiguous, one dtype
    (fp32 or bf16), dh <= 256. ``window > 0`` also masks the positions below
    ``kv_len - window``."""
    library.refuse_grad("decode_attention", q, k, v,
                        item="decode is serve-only; " + library.TRAINING_ITEM)
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
    if k.shape[0] != b or k.shape[3] != dh or hq % hkv or dh > 256 \
            or window < 0:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    scale = dh ** -0.5
    lib = library.library()
    nsplit = num_splits(sm_count(q.device.index), b, hkv, smax)
    scratch = torch.empty(
        lib.decode_attention_scratch_floats(b, hq, hkv, dh, nsplit),
        dtype=torch.float32, device=q.device)
    stream = library.stream_of(q)
    counters = arrival_counters(q.device, stream,
                                lib.decode_attention_rows(b, hq, hkv))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        library.launch("decode_attention_launch", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                       scratch.data_ptr(), counters.data_ptr(), b, smax, hq,
                       hkv, dh, nsplit, int(window), float(scale),
                       library.DTYPE_CODES[q.dtype], stream)
    decode_attention_fwd.launches += 1
    return out


decode_attention_fwd.launches = 0
