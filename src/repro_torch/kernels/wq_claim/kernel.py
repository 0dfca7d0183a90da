"""Launcher of the CUDA claim kernel (``csrc/wq_claim.cu``).

Replaces the TPU kernel ``repro/kernels/wq_claim/kernel.py``
(``_claim_kernel`` / ``wq_claim_fwd``); the source note in the ``.cu`` file
says what bounds it on the card and how its three passes answer that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library


def wq_claim_fwd(status: torch.Tensor, worker: torch.Tensor, *,
                 num_workers: int, k: int):
    """status/worker: contiguous int32 [N] CUDA tensors. Returns
    (new_status [N], claimed [N]) int32, computed on the card."""
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
    lib = library.library()
    table = torch.empty(lib.wq_claim_scratch_ints(n, num_workers),
                        dtype=torch.int32, device=status.device)
    with torch.cuda.device(status.device):
        library.launch("wq_claim_launch", status.data_ptr(),
                       worker.data_ptr(), new_status.data_ptr(),
                       claimed.data_ptr(), table.data_ptr(), n, num_workers,
                       int(k), library.stream_of(status))
    wq_claim_fwd.launches += 1
    return new_status, claimed


wq_claim_fwd.launches = 0
