"""Straggler mitigation: work stealing + speculative re-execution.

Stealing is built into WorkQueue.claim(..., allow_steal=True) / claim_all
(paper's load-balancing flexibility). This module adds speculative
re-execution: RUNNING tasks whose elapsed time exceeds a percentile of the
completed-task distribution get a duplicate READY copy (first-writer-wins at
commit; duplicates are reconciled by task id).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.schema import Status
from repro_torch.core.workqueue import WorkQueue


class SpeculativeReexec:
    def __init__(self, wq: WorkQueue, percentile: float = 95.0,
                 min_samples: int = 20, factor: float = 2.0):
        self.wq = wq
        self.percentile = percentile
        self.min_samples = min_samples
        self.factor = factor
        self.speculated: Dict[int, int] = {}   # original task -> clone task

    def threshold(self) -> float:
        st = self.wq.store.col("status")
        fin = st == int(Status.FINISHED)
        if fin.sum() < self.min_samples:
            return np.inf
        dur = (self.wq.store.col("end_time")[fin]
               - self.wq.store.col("start_time")[fin])
        return float(np.percentile(dur, self.percentile) * self.factor)

    def sweep(self, now: float) -> List[int]:
        """Clone slow RUNNING tasks as READY duplicates."""
        thr = self.threshold()
        if not np.isfinite(thr):
            return []
        st = self.wq.store.col("status")
        running = np.nonzero(st == int(Status.RUNNING))[0]
        t0 = self.wq.store.col("start_time")[running]
        # expired-lease rows belong to the REAPER (they requeue, and the
        # original re-runs); cloning them here would double-execute. NaN
        # expires_at (no lease) compares False, so unleased rows still
        # speculate as before.
        exp = self.wq.store.col("expires_at")[running]
        slow = running[((now - t0) > thr) & ~(exp < now)]
        cloned = []
        for row in slow:
            tid = int(self.wq.store.col("task_id")[row])
            if tid in self.speculated:
                continue
            act = int(self.wq.store.col("activity_id")[row])
            dom = np.asarray([[self.wq.store.col(f"in{i}")[row]
                               for i in range(3)]])
            new = self.wq.add_tasks(act, 1, domain_in=dom, now=now)
            self.speculated[tid] = int(new[0])
            cloned.append(int(new[0]))
        return cloned

    def reconcile(self) -> int:
        """First-writer-wins: when either copy FINISHES, prune the other."""
        st = self.wq.store.col("status")
        tid_col = self.wq.store.col("task_id")
        id_to_row = {int(t): i for i, t in enumerate(tid_col)}
        pruned = 0
        for orig, clone in list(self.speculated.items()):
            ro, rc = id_to_row.get(orig), id_to_row.get(clone)
            if ro is None or rc is None:
                continue
            fo = st[ro] == int(Status.FINISHED)
            fc = st[rc] == int(Status.FINISHED)
            if fo or fc:
                loser = rc if fo else ro
                if st[loser] in (int(Status.READY), int(Status.RUNNING)):
                    self.wq.store.update(np.asarray([loser]),
                                         status=int(Status.PRUNED))
                    pruned += 1
                del self.speculated[orig]
        return pruned
