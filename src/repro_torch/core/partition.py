"""WQ partitioning: hash by worker id (paper Section 3.2).

The supervisor assigns ``worker_id = task_id % W`` round-robin ("the
supervisor circularly assigns a worker id to each task"), which yields
balanced partitions for uniform workloads. ``rehash`` supports elastic
W -> W' re-partitioning (only rows whose assignment changes move — stable
task ids).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def assign_workers(task_ids: np.ndarray, num_workers: int) -> np.ndarray:
    return (task_ids % num_workers).astype(np.int32)


def rehash(worker_ids: np.ndarray, task_ids: np.ndarray, new_workers: int,
           only_statuses: np.ndarray = None) -> Tuple[np.ndarray, int]:
    """Re-partition to ``new_workers``; returns (new_assignment, n_moved)."""
    new = assign_workers(task_ids, new_workers)
    moved = int(np.sum(new != worker_ids))
    return new, moved


def partition_sizes(worker_ids: np.ndarray, num_workers: int) -> np.ndarray:
    return np.bincount(worker_ids[worker_ids >= 0], minlength=num_workers)


def imbalance(worker_ids: np.ndarray, num_workers: int) -> float:
    sizes = partition_sizes(worker_ids, num_workers)
    if sizes.sum() == 0:
        return 0.0
    return float(sizes.max() / max(sizes.mean(), 1e-9) - 1.0)
