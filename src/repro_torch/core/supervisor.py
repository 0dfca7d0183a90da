"""Supervisor: task generation + activity-dependency expansion + failover.

The supervisor is the only component that INSERTS tasks (paper Fig. 2); it
never sits in the claim path. A secondary supervisor keeps a shadow of the
expansion cursor + txn-log offset and can be promoted at any time (removes
the paper's single point of failure).

Workflow model: a chain of activities (the Risers pipeline is 7 linked
activities); finishing a task of activity k spawns its dependent task of
activity k+1 (1:1 pipeline, matching the paper's synthetic workloads), with
optional fan-out. Domain outputs of the parent seed the child's inputs —
that is the dataflow the provenance queries (Q7/Q8) traverse.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.risers_workflow import WorkflowConfig
from repro_torch.core.schema import Status
from repro_torch.core.workqueue import WorkQueue


@dataclass
class SupervisorState:
    expanded_upto: Dict[int, int] = field(default_factory=dict)
    log_offset: int = 0
    generation: int = 0          # bumped on promote (fencing token)


class Supervisor:
    def __init__(self, wq: WorkQueue, workflow: WorkflowConfig,
                 fanout: int = 1):
        self.wq = wq
        self.workflow = workflow
        self.fanout = fanout
        self.state = SupervisorState()
        self.alive = True

    # ------------------------------------------------------------- seeding
    def seed(self, n_tasks: int, *, duration_s: float, rng: np.random.Generator,
             now: float = 0.0) -> np.ndarray:
        """Insert the activity-0 tasks with synthetic domain params."""
        lo, hi = self.workflow.param_low, self.workflow.param_high
        dom = rng.uniform(lo, hi, size=(n_tasks, 3))
        # controlled synthetic durations (the paper repeats runs to <1% std;
        # a heavy-tailed distribution would measure tail effects instead of
        # scheduler behavior)
        dur = rng.normal(duration_s, 0.1 * duration_s, n_tasks).clip(
            duration_s * 0.5, duration_s * 2.0)
        # durations go through add_tasks (one logged insert) so replicas
        # replaying the txn log reproduce them exactly
        return self.wq.add_tasks(0, n_tasks, domain_in=dom, now=now,
                                 duration_est=dur)

    # ------------------------------------------------------------ expansion
    def expand(self, now: float = 0.0) -> int:
        """Spawn activity-(k+1) tasks for newly FINISHED activity-k tasks.

        Dedup is carried by the store's ``expanded`` column, flipped in the
        SAME transaction/log record that inserts the children: correct under
        out-of-order finishes (a task finishing after a higher row index has
        already been expanded still gets its children), and a supervisor
        promoted onto a recovered replica resumes exactly — no duplicate and
        no lost expansions, because the watermark replicates with the data.
        """
        if not self.alive:
            return 0
        n_new = 0
        store = self.wq.store
        for k in range(self.workflow.num_activities - 1):
            st = store.col("status")
            act = store.col("activity_id")
            exp = store.col("expanded")
            rows = np.nonzero((st == int(Status.FINISHED)) & (act == k)
                              & (exp == 0))[0]
            if len(rows) == 0:
                continue
            parents = store.col("task_id")[rows]
            # child inputs = parent outputs (dataflow provenance edge)
            dom = np.stack([store.col(f"out{i}")[rows] for i in range(3)],
                           axis=1)
            dom = np.nan_to_num(dom, nan=0.0)
            dur = store.col("duration_est")[rows]
            ids = self.wq.add_tasks(k + 1, len(rows) * self.fanout,
                                    domain_in=np.repeat(dom, self.fanout, 0),
                                    parent_task=np.repeat(parents,
                                                          self.fanout),
                                    duration_est=np.repeat(dur, self.fanout),
                                    now=now,
                                    mark_expanded=rows)
            self.state.expanded_upto[k] = \
                self.state.expanded_upto.get(k, 0) + len(rows)
            n_new += len(ids)
        return n_new

    def done(self) -> bool:
        c = self.wq.counts()
        return (c["READY"] == 0 and c["RUNNING"] == 0
                and c["BLOCKED"] == 0)

    # -------------------------------------------------------------- failover
    def crash(self):
        self.alive = False


class SecondarySupervisor:
    """Shadow: tracks the primary's state via the txn log; promote() yields a
    fully functional Supervisor that resumes expansion exactly where the
    primary stopped (dedup via the expansion cursor)."""

    def __init__(self, primary: Supervisor):
        self.primary = primary
        self.shadow = SupervisorState()

    def sync(self):
        self.shadow.expanded_upto = dict(self.primary.state.expanded_upto)
        self.shadow.log_offset = len(self.primary.wq.log)

    def promote(self, wq: Optional[WorkQueue] = None) -> Supervisor:
        """Promote onto the primary's WQ, or — after data-node loss — onto a
        WorkQueue recovered from a replica (``DeltaReplicator.recover()``).

        The expansion watermark is the store's ``expanded`` column, so the
        promoted supervisor needs no cursor handoff: it derives exactly
        which FINISHED tasks still lack children from the recovered data
        itself. The shadow cursor is kept as an observability counter.
        """
        target = wq if wq is not None else self.primary.wq
        sup = Supervisor(target, self.primary.workflow, self.primary.fanout)
        sup.state = SupervisorState(
            expanded_upto=dict(self.shadow.expanded_upto),
            log_offset=self.shadow.log_offset,
            generation=self.primary.state.generation + 1)
        return sup
