"""Work-Queue relation schema (paper Fig. 3) + task status machine.

The WQ relation holds execution data (scheduling), domain data (task
parameters/results) and provenance links in ONE store — the paper's central
design decision (Section 2: storing them separately causes redundancy and
blocks runtime analysis).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


class Status(enum.IntEnum):
    EMPTY = 0        # unallocated row
    BLOCKED = 1      # waiting on dependency (upstream activity)
    READY = 2
    RUNNING = 3
    FINISHED = 4
    FAILED = 5       # exhausted fail_trials
    PRUNED = 6       # removed by user steering (paper's data reduction / Q8)


# legal transitions of the task state machine
TRANSITIONS: Dict[int, Tuple[int, ...]] = {
    Status.EMPTY: (Status.BLOCKED, Status.READY),
    Status.BLOCKED: (Status.READY, Status.PRUNED),
    Status.READY: (Status.RUNNING, Status.PRUNED),
    Status.RUNNING: (Status.FINISHED, Status.READY, Status.FAILED),
    # RUNNING->READY = retry after worker failure (fail_trials += 1)
    Status.FINISHED: (),
    Status.FAILED: (),
    Status.PRUNED: (),
}


def _transition_matrix() -> np.ndarray:
    m = np.zeros((int(max(Status)) + 1, int(max(Status)) + 1), bool)
    for frm, tos in TRANSITIONS.items():
        for to in tos:
            m[int(frm), int(to)] = True
    return m


# boolean legality matrix indexed [current_status, to]: lets the WorkQueue
# validate a whole batch with one gather instead of a per-status Python loop
LEGAL_TRANSITIONS = _transition_matrix()


@dataclass(frozen=True)
class Column:
    name: str
    dtype: np.dtype
    default: float = 0


# Fig. 3 columns (Task Id, Act Id, Worker Id, Core, Fail.Trials, Start/End
# Time, Status) + provenance (parent task) + generic domain slots. Command
# line / stdout raw strings live in the side table (store.py blobs), exactly
# like the paper keeps raw files out of the DBMS and pointers inside.
def wq_schema(num_domain_in: int = 3, num_domain_out: int = 3
              ) -> List[Column]:
    cols = [
        Column("task_id", np.dtype(np.int64), -1),
        Column("activity_id", np.dtype(np.int32), -1),
        Column("worker_id", np.dtype(np.int32), -1),
        Column("core_id", np.dtype(np.int32), -1),
        Column("status", np.dtype(np.int32), int(Status.EMPTY)),
        Column("fail_trials", np.dtype(np.int32), 0),
        Column("submit_time", np.dtype(np.float64), np.nan),
        Column("start_time", np.dtype(np.float64), np.nan),
        Column("end_time", np.dtype(np.float64), np.nan),
        # Work Claim Pattern lease columns: a claim stamps claimed_at /
        # heartbeat_at and an expiry deadline in the SAME transaction as the
        # RUNNING flip, so worker liveness lives in the relation itself —
        # an expired lease is reaped as a data-plane event (reap_expired),
        # no supervisor round-trip needed. NaN = row holds no lease.
        Column("claimed_at", np.dtype(np.float64), np.nan),
        Column("heartbeat_at", np.dtype(np.float64), np.nan),
        Column("expires_at", np.dtype(np.float64), np.nan),
        Column("duration_est", np.dtype(np.float64), 0.0),  # simulated cost
        Column("parent_task", np.dtype(np.int64), -1),      # provenance edge
        # dependency-expansion watermark: 1 once the supervisor has spawned
        # this FINISHED task's children. Lives IN the relation (not in
        # supervisor memory) so failover dedup survives data-node loss: a
        # promoted supervisor on a recovered replica derives exactly which
        # parents still need expansion from the store itself.
        Column("expanded", np.dtype(np.int32), 0),
        Column("bytes_in", np.dtype(np.int64), 0),
        Column("bytes_out", np.dtype(np.int64), 0),
    ]
    for i in range(num_domain_in):
        cols.append(Column(f"in{i}", np.dtype(np.float64), np.nan))
    for i in range(num_domain_out):
        cols.append(Column(f"out{i}", np.dtype(np.float64), np.nan))
    return cols


TERMINAL = (Status.FINISHED, Status.FAILED, Status.PRUNED)
