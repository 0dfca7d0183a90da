"""Launcher of the CUDA claim kernel (``csrc/wq_claim.cu``).

Replaces the TPU kernel ``repro/kernels/wq_claim/kernel.py``
(``_claim_kernel`` / ``wq_claim_fwd``); the source note in the ``.cu`` file
says what bounds it on the card and how its one cooperative launch answers
that.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import library

_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def scratch(device: torch.device, stream: int, ints: int) -> torch.Tensor:
    """The kernel's scratch: two grid-barrier words, zeroed when the buffer
    is made (a call leaves the first zeroed and zeroes the second before it
    uses it), then ``ints`` ints that a call writes before it reads them.
    One buffer per (device, stream), so that calls that may run at once
    never share one; grows when a call needs more."""
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < 2 + ints:
        buf = torch.zeros(2 + max(ints, 1 << 16), dtype=torch.int32,
                          device=device)
        _SCRATCH[key] = buf
    return buf


@functools.lru_cache(maxsize=256)
def scratch_ints(device_index: int, n: int, num_workers: int) -> int:
    """Ints of scratch a call on ``n`` rows and ``num_workers`` workers
    needs after the barrier words (asked of the library once per shape; the
    caller has made ``device_index`` current)."""
    lib = library.library()
    ints = lib.wq_claim_scratch_ints(n, num_workers)
    if ints < 0:
        raise RuntimeError(f"wq_claim: CUDA error {-ints} "
                           f"({lib.repro_cuda_error_string(-ints).decode()})")
    return ints


def wq_claim_fwd(status: torch.Tensor, worker: torch.Tensor, *,
                 num_workers: int, k: int):
    """status/worker: contiguous int32 [N] CUDA tensors. Returns
    (new_status [N], claimed [N]) int32, computed on the card in one
    launch."""
    library.require_cuda("wq_claim", status, worker)
    if status.dtype != torch.int32 or worker.dtype != torch.int32:
        raise TypeError("wq_claim: status and worker must be int32")
    if status.dim() != 1 or status.shape != worker.shape:
        raise ValueError(f"wq_claim: expected two [N] columns, got "
                         f"{tuple(status.shape)} and {tuple(worker.shape)}")
    if num_workers < 1:
        raise ValueError("wq_claim: num_workers must be >= 1")
    n = status.shape[0]
    new_status = torch.empty_like(status)
    claimed = torch.empty_like(status)
    if n == 0:
        return new_status, claimed
    stream = library.stream_of(status)
    with torch.cuda.device(status.device):
        buf = scratch(status.device, stream,
                      scratch_ints(status.device.index, n, num_workers))
        library.launch("wq_claim_launch", status.data_ptr(),
                       worker.data_ptr(), new_status.data_ptr(),
                       claimed.data_ptr(), buf.data_ptr(), buf.numel(), n,
                       num_workers, int(k), stream)
    wq_claim_fwd.launches += 1
    return new_status, claimed


wq_claim_fwd.launches = 0


def empty_launch(status: torch.Tensor, num_workers: int) -> None:
    """Launch an empty kernel as ``wq_claim_fwd`` would launch the claim
    kernel on ``status`` (the same grid, block and shared memory,
    cooperatively): what one launch costs at the least. Not counted as a
    launch of the claim kernel."""
    library.require_cuda("wq_claim", status)
    with torch.cuda.device(status.device):
        library.launch("wq_claim_empty_launch", status.shape[0], num_workers,
                       library.stream_of(status))
