"""Plain PyTorch version of the work-queue claim op.

Same function as the reference package's oracle (a per-worker one-hot
cumsum): each worker claims its first k READY rows in row order; a row whose
worker id lies outside [0, W) gets rank 0. Written with a stable sort so
that it stays linear in memory at the store sizes the claim path sees.
"""
from __future__ import annotations

import torch

READY = 2
RUNNING = 3


def wq_claim_ref(status: torch.Tensor, worker: torch.Tensor, *,
                 num_workers: int, k: int):
    """status/worker: int32 [N]. Returns (new_status, claimed) int32 [N]."""
    n = status.shape[0]
    ready = status == READY
    counted = ready & (worker >= 0) & (worker < num_workers)
    key = torch.where(counted, worker.long(), num_workers)
    order = torch.sort(key, stable=True).indices
    skey = key[order]
    counts = torch.bincount(skey, minlength=num_workers + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty(n, dtype=torch.long, device=status.device)
    rank[order] = torch.arange(n, device=status.device) - starts[skey]
    rank = torch.where(counted, rank, 0)
    claim = ready & (rank < k)
    return (torch.where(claim, RUNNING, status).to(torch.int32),
            claim.to(torch.int32))
