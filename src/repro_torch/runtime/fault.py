"""Fault handling: heartbeats, failure detection/injection, recovery drill.

The paper's availability story (Section 3.1): every component is replaceable
— data-node loss is covered by replication (core/replication.py), worker
loss by requeue + rehash (workqueue.requeue_worker), supervisor loss by the
secondary. This module adds the detection loop and a deterministic failure
injector used by tests and the fault-tolerance example.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.workqueue import WorkQueue


@dataclasses.dataclass
class Heartbeat:
    worker_id: int
    last_seen: float


class HeartbeatMonitor:
    def __init__(self, wq: WorkQueue, timeout_s: float = 30.0,
                 now: Optional[float] = None):
        self.wq = wq
        self.timeout_s = timeout_s
        t0 = now if now is not None else time.time()
        self.beats: Dict[int, float] = {
            w: t0 for w in range(wq.num_workers)}
        self.dead: set = set()

    def beat(self, worker_id: int, now: Optional[float] = None) -> None:
        self.beats[worker_id] = now if now is not None else time.time()
        self.dead.discard(worker_id)

    def resync(self, now: Optional[float] = None) -> None:
        """Rebuild the beat map after ``WorkQueue.resize``: drop entries for
        removed workers (a stale entry would otherwise re-trigger a
        requeue_worker on every sweep forever) and seed newly added workers
        at ``now`` so they get a full timeout before being declared dead."""
        now = now if now is not None else time.time()
        live = range(self.wq.num_workers)
        self.beats = {w: self.beats.get(w, now) for w in live}
        self.dead &= set(live)

    def sweep(self, now: Optional[float] = None) -> List[int]:
        """Detect dead workers and requeue their RUNNING tasks."""
        now = now if now is not None else time.time()
        if len(self.beats) != self.wq.num_workers \
                or self.wq.num_workers - 1 not in self.beats:
            self.resync(now)       # pool was resized since the last sweep
        newly_dead = []
        for w, seen in self.beats.items():
            if w in self.dead:
                continue
            if now - seen > self.timeout_s:
                self.dead.add(w)
                n = self.wq.requeue_worker(w)
                newly_dead.append(w)
        return newly_dead


class FailureInjector:
    """Deterministic failure schedule for tests/examples: kill worker w at
    tick t, crash the supervisor at tick t', drop a fraction of tasks."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.schedule: List[tuple] = []

    def kill_worker_at(self, tick: int, worker_id: int):
        self.schedule.append((tick, "worker", worker_id))
        return self

    def crash_supervisor_at(self, tick: int):
        self.schedule.append((tick, "supervisor", None))
        return self

    def fail_task_fraction(self, frac: float):
        self.schedule.append((-1, "task_noise", frac))
        return self

    def events_at(self, tick: int) -> List[tuple]:
        return [e for e in self.schedule if e[0] == tick]

    def should_fail_task(self) -> bool:
        for t, kind, frac in self.schedule:
            if kind == "task_noise" and self.rng.random() < frac:
                return True
        return False
