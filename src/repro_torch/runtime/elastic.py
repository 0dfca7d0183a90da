"""Elastic scaling: resize the worker set W -> W' at runtime.

The WQ re-hash is core (workqueue.resize, stable task ids, minimal moves);
this module adds the orchestration policy: when to grow/shrink based on the
queue depth vs worker throughput, mirroring an autoscaler at 1000+ nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.workqueue import WorkQueue


@dataclasses.dataclass
class ElasticPolicy:
    min_workers: int = 1
    max_workers: int = 4096
    target_tasks_per_worker: float = 8.0
    hysteresis: float = 0.5     # only act when off-target by >50%
    # staleness escalation (the HPA side of the Work Claim Pattern): when
    # the oldest pending task or the p95 submit-to-claim latency exceeds
    # these, the pool is starved regardless of the count-based target —
    # grow by `escalation_factor` and BYPASS the hysteresis band. inf
    # disables (pure count-based scaling, the pre-lease behavior).
    max_backlog_age_s: float = float("inf")
    max_claim_p95_s: float = float("inf")
    escalation_factor: float = 2.0


class ElasticController:
    def __init__(self, wq: WorkQueue, policy: Optional[ElasticPolicy] = None):
        self.wq = wq
        self.policy = policy or ElasticPolicy()
        self.resizes = 0
        self.last_signals: Optional[dict] = None
        self._escalated = False

    def desired_workers(self, now: Optional[float] = None) -> int:
        """Pool size from the relation's own autoscaling signals
        (``WorkQueue.autoscale_signals``): pending backlog / target ratio,
        escalated past the count target when the backlog is STALE (age or
        p95 claim latency over threshold — only meaningful when ``now`` is
        supplied on the workload clock)."""
        p = self.policy
        sig = self.wq.autoscale_signals(
            now=now if now is not None else 0.0)
        self.last_signals = sig
        want = int(np.clip(round(sig["pending"] / p.target_tasks_per_worker),
                           p.min_workers, p.max_workers))
        self._escalated = bool(
            now is not None and sig["pending"] > 0
            and (sig["backlog_age_s"] > p.max_backlog_age_s
                 or sig["claim_p95_s"] > p.max_claim_p95_s))
        if self._escalated:
            want = int(np.clip(
                round(max(want, self.wq.num_workers) * p.escalation_factor),
                p.min_workers, p.max_workers))
        return max(want, p.min_workers)

    def maybe_resize(self, now: Optional[float] = None) -> Optional[int]:
        want = self.desired_workers(now)
        cur = self.wq.num_workers
        if want == cur:
            return None
        if not self._escalated \
                and abs(want - cur) / max(cur, 1) < self.policy.hysteresis:
            return None
        moved = self.wq.resize(want)
        self.resizes += 1
        return want
