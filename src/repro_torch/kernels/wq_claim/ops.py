"""Dispatcher for the work-queue claim op: by the tensors' device.

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the plain PyTorch version. There is no other route.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.wq_claim.kernel import wq_claim_fwd
from repro_torch.kernels.wq_claim.ref import wq_claim_ref


def wq_claim(status: torch.Tensor, worker: torch.Tensor, *, num_workers: int,
             k: int = 1):
    """Any N (no padding). Returns (new_status [N], claimed [N]) int32."""
    if status.device.type == "cuda":
        return wq_claim_fwd(status, worker, num_workers=num_workers, k=k)
    if status.device.type != "cpu":
        raise ValueError(f"wq_claim: unsupported device {status.device}")
    return wq_claim_ref(status, worker, num_workers=num_workers, k=k)


def wq_claim_columns(status: np.ndarray, worker: np.ndarray, *,
                     num_workers: int, k: int = 1, device="cuda"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-facing bridge for WorkQueue's device claim path.

    Takes the store's numpy status/worker columns, runs the claim op on
    ``device``, and returns numpy ``(claim_mask [N] bool, new_status [N]
    int32)`` for the control plane to apply to the authoritative host store.
    """
    if status.size == 0:
        return (np.zeros(0, bool), np.zeros(0, np.int32))
    dev = torch.device(device)
    new_status, claimed = wq_claim(
        torch.tensor(np.asarray(status, np.int32), device=dev),
        torch.tensor(np.asarray(worker, np.int32), device=dev),
        num_workers=num_workers, k=k)
    return (claimed.cpu().numpy().astype(bool),
            new_status.cpu().numpy().astype(np.int32, copy=False))
