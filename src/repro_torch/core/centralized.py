"""Chiron-style centralized execution control — the Experiment 8 baseline.

Centralized design (paper Fig. 6-B): every worker request hops through ONE
master; the master serializes access to ONE unpartitioned queue; each claim
scans the whole queue; an extra acknowledgement message closes the loop.
We model the per-request costs the paper identifies: (1) request queueing at
the master, (2) serialized full-queue scan, (3) ack round-trip.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.schema import Status
from repro_torch.core.store import ColumnStore


class CentralizedMaster:
    def __init__(self, store: Optional[ColumnStore] = None,
                 capacity: int = 1 << 16):
        self.store = store or ColumnStore(capacity=capacity)
        self._next_task_id = 0
        self.total_messages = 0      # request + reply + ack per claim

    def add_tasks(self, activity_id: int, n: int, *, now: float = 0.0
                  ) -> np.ndarray:
        ids = np.arange(self._next_task_id, self._next_task_id + n,
                        dtype=np.int64)
        self._next_task_id += n
        self.store.insert({
            "task_id": ids,
            "activity_id": np.full(n, activity_id, np.int32),
            "worker_id": np.full(n, -1, np.int32),   # assigned at claim time
            "status": np.full(n, int(Status.READY), np.int32),
            "submit_time": np.full(n, now, np.float64),
        })
        return ids

    def claim(self, worker_id: int, k: int = 1, *, now: float = 0.0
              ) -> np.ndarray:
        """One serialized master transaction: full-queue scan + assignment.

        Returns claimed rows; the caller accounts the wall time of this call
        as master occupancy (no two claims overlap — that is the bottleneck
        the paper measures two orders of magnitude of).
        """
        status = self.store.col("status")              # full scan
        idx = np.nonzero(status == int(Status.READY))[0][:k]
        if len(idx):
            self.store.update(idx, status=int(Status.RUNNING),
                              worker_id=worker_id, start_time=now)
        self.total_messages += 3    # request, reply, ack (Fig. 6-B)
        return idx

    def finish(self, idx: np.ndarray, *, now: float = 0.0) -> None:
        self.store.update(np.asarray(idx), status=int(Status.FINISHED),
                          end_time=now)
        self.total_messages += 2    # completion + ack
