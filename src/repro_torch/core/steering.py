"""Steering engine: the paper's runtime analytical queries (Table 2) + the
dynamic adaptations they enable (Q8 / data reduction).

Q1-Q6 analyze execution metadata, Q7 joins execution + provenance + domain
data, Q8 *adapts* the workflow (patches inputs of READY tasks).

HTAP isolation: analytical queries execute against an immutable
:class:`~repro.core.store.SnapshotView` (``run_all`` pins one snapshot for
the whole sweep), so a sweep observes ONE committed store version while
claims keep mutating the live arrays concurrently — no READY/RUNNING
double-counts across queries, the consistency half of the paper's
single-database argument. Q8 and prune are transactions: they always write
the LIVE store (reading their predicates live too), never a snapshot.

``device_monitor`` runs the same reductions with torch on a device mirror
of the columns.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from repro_torch import trace
from repro_torch.core.schema import Status
from repro_torch.core.store import SnapshotView
from repro_torch.core.workqueue import WorkQueue


# Q7 join parameters — one definition shared by the single-primary query
# (q7_provenance_join defaults), the distributed partial sweep below, and
# ShardRouter's merge, so every sweep path answers the same question.
Q7_ACT_A, Q7_ACT_B, Q7_THR = 0, 2, 0.5


def sweep_partials(view: SnapshotView, num_workers: int, now: float,
                   horizon: float = 60.0) -> Dict[str, object]:
    """Per-shard half of the distributed Q1-Q7 sweep: PURE and picklable.

    Reduces one pinned snapshot to the partial aggregates
    ``ShardRouter.merge_partials`` combines into the single-primary result
    — Q1/Q3 per-worker bincount slabs, the Q4 open count, Q5/Q6 segment
    partials, Q7's duration sum/count, and the COMPACTED ancestry inputs
    (ids/activity/parent/pruned of every materialized row, plus the
    pre-mean Q7 candidate hits) the cross-shard provenance walk needs.
    Rows are compact indices into the ``anc_*`` arrays, not store rows, so
    a partial computed inside a replica process merges bit-identically
    with one computed from a local view: nothing here depends on where
    the snapshot lives. Every numpy reduction matches the single-primary
    queries op-for-op — that is what keeps the merged result bit-identical
    (dyadic times assumed, as everywhere in the parity drills).
    """
    st = view.col("status")
    wid = view.col("worker_id")
    t0 = view.col("start_time")
    t1 = view.col("end_time")
    act = view.col("activity_id")
    L = int(num_workers)
    empty_i = np.zeros(0, np.int64)
    p: Dict[str, object] = {
        "n_workers": L, "version": int(view.version),
        "started": np.zeros(L, np.int64),
        "finished": np.zeros(L, np.int64),
        "failures": np.zeros(L, np.int64),
        "fail_counts": np.zeros(L, np.int64),
        "q5_counts": empty_i,
        "q6_cnt": empty_i, "q6_sum": np.zeros(0, np.float64),
        "q6_max": np.zeros(0, np.float64),
        "q7_sum": 0.0, "q7_cnt": 0, "q7_any": False,
    }
    # Q1 slab: recent rows bucketed by local worker id
    recent = (t0 >= now - horizon) & (st != int(Status.EMPTY))
    rw = wid[recent]
    if rw.size:
        p["started"] = np.bincount(rw, minlength=L)
        p["finished"] = np.bincount(
            rw, weights=(st[recent] == int(Status.FINISHED)),
            minlength=L).astype(np.int64)
        p["failures"] = np.bincount(
            rw, weights=view.col("fail_trials")[recent],
            minlength=L).astype(np.int64)
    # Q3 slab: FAILED-recently counts per local worker
    m3 = (st == int(Status.FAILED)) & (t1 >= now - horizon)
    if m3.any():
        p["fail_counts"] = np.bincount(wid[m3], minlength=L)
    # Q4 / Q5: open rows
    mo = np.isin(st, [int(Status.READY), int(Status.RUNNING),
                      int(Status.BLOCKED)])
    p["q4"] = int(mo.sum())
    if mo.any():
        p["q5_counts"] = np.bincount(act[mo])
    # Q6 partials per activity: finished count / duration sum / max
    fin = st == int(Status.FINISHED)
    p["q6_open"] = np.unique(act[np.isin(
        st, [int(Status.READY), int(Status.RUNNING)])])
    af = act[fin]
    if af.size:
        d = t1[fin] - t0[fin]
        n_act = int(af.max()) + 1
        p["q6_cnt"] = np.bincount(af, minlength=n_act)
        p["q6_sum"] = np.bincount(af, weights=d, minlength=n_act)
        q6_max = np.full(n_act, -np.inf)
        np.maximum.at(q6_max, af, d)
        p["q6_max"] = q6_max
    # Q7 scalar partials: duration sum/count over finished act_b rows
    # (the global mean only exists at merge time)
    fb = fin & (act == Q7_ACT_B)
    if fb.any():
        db = (t1 - t0)[fb]
        p["q7_any"] = True
        p["q7_sum"] = float(np.nansum(db))
        p["q7_cnt"] = int((~np.isnan(db)).sum())
    # ancestry inputs: every materialized row, order-preserving compaction
    # (PRUNED tombstones included — live rows shadow them at merge)
    sel = st != int(Status.EMPTY)
    p["anc_ids"] = view.col("task_id")[sel]
    p["anc_act"] = act[sel]
    p["anc_parent"] = view.col("parent_task")[sel]
    p["anc_pruned"] = st[sel] == int(Status.PRUNED)
    # Q7 candidate hits as COMPACT indices, durations kept for the
    # merge-time global-mean filter
    c_st = st[sel]
    c_act = act[sel]
    cand = (c_st == int(Status.FINISHED)) & (c_act == Q7_ACT_B) \
        & (view.col("out0")[sel] > Q7_THR)
    p["hit_idx"] = np.nonzero(cand)[0].astype(np.int64)
    p["hit_dur"] = (t1 - t0)[sel][cand]
    return p


class SteeringEngine:
    def __init__(self, wq: WorkQueue, *, use_snapshots: bool = True):
        self.wq = wq
        self.use_snapshots = use_snapshots
        # the pinned view is THREAD-LOCAL: an analyst thread's sweep must not
        # leak its snapshot into live queries issued from other threads
        self._tls = threading.local()

    # --------------------------------------------------------------- helpers
    def _store(self):
        """Read-side source: the snapshot pinned by this thread's sweep, else
        the live store (single queries are trivially consistent)."""
        view = getattr(self._tls, "view", None)
        return view if view is not None else self.wq.store

    def _cols(self, *names):
        v = self._store()
        return tuple(v.col(n) for n in names)

    @contextlib.contextmanager
    def snapshot_scope(self, view: Optional[SnapshotView] = None):
        """Pin all queries in the block (on this thread) to one version."""
        prev = getattr(self._tls, "view", None)
        self._tls.view = view if view is not None \
            else self.wq.store.snapshot_view()
        try:
            yield self._tls.view
        finally:
            self._tls.view = prev

    # ---------------------------------------------------------- time travel
    def at_version(self, version: int,
                   base: Optional[SnapshotView] = None) -> SnapshotView:
        """Pin a sweep to ANY historical committed version.

        Rebuilds an immutable view of the store as of ``version`` by
        snapshot-restore + bounded txn-log replay: start from ``base`` (any
        snapshot at a version <= the target; an empty store when omitted) and
        replay exactly the log records in ``(base.version, version]`` — the
        two boundaries are bisected, the replay is O(delta). Pass the result
        as ``run_all(now, view=...)`` (or to ``snapshot_scope``) to run the
        whole Q1-Q7 sweep against history.

        Requires every mutation since ``base`` to have gone through the
        logged WorkQueue/steering API (true for the executor and simkit
        paths); raw ``store.update`` calls are invisible to the log and
        cannot be time-traveled. Once ``TxnLog.truncate`` has compacted the
        consumed prefix, genesis replay degrades to "since the last
        checkpoint": pass a ``base`` snapshot at or after the log's
        compaction horizon (e.g. the checkpointed store) or this raises
        :class:`~repro_torch.core.transactions.LogCompactedError`.
        """
        from repro_torch.core.replication import replay
        from repro_torch.core.transactions import LogCompactedError
        live = self.wq.store
        if version > live.version:
            raise ValueError(f"version {version} is in the future "
                             f"(live store is at {live.version})")
        if base is not None and base.version > version:
            raise ValueError(f"base snapshot v{base.version} is newer than "
                             f"target v{version}")
        if base is None:
            store = type(live)(live.schema, capacity=1 << 10)
            after = store.version            # 0: replay the log from genesis
        else:
            store = type(live).from_view(base, live.schema)
            after = base.version
        try:
            delta = self.wq.log.records_between(after, version)
        except LogCompactedError as e:
            raise LogCompactedError(
                f"cannot time-travel to v{version} from "
                f"{'genesis' if base is None else f'base v{base.version}'}: "
                f"{e}") from None
        replay(store, delta)
        store.set_version(version)
        return store.snapshot_view()

    # Q1: per-node task status counts within the last minute
    def q1_recent_status_by_node(self, now: float, horizon: float = 60.0
                                 ) -> Dict[int, Dict[str, int]]:
        """Loop-free sweep: one segment reduction (bincount over the worker
        ids of the recent rows) per metric, instead of re-masking the whole
        store once per distinct worker."""
        st, wid, t0 = self._cols("status", "worker_id", "start_time")
        recent = (t0 >= now - horizon) & (st != int(Status.EMPTY))
        fails = self._store().col("fail_trials")
        rw = wid[recent]
        if not rw.size:
            return {}
        workers, inv = np.unique(rw, return_inverse=True)
        started = np.bincount(inv)
        finished = np.bincount(
            inv, weights=(st[recent] == int(Status.FINISHED)))
        failures = np.bincount(inv, weights=fails[recent])
        return {int(w): {"started": int(s), "finished": int(f),
                         "failures": int(x)}
                for w, s, f, x in zip(workers, started, finished, failures)}

    # Q2: per-task bytes consumed on a node, finished in last minute
    def q2_bytes_by_task(self, worker: int, now: float, horizon: float = 60.0
                         ) -> np.ndarray:
        st, wid, te, bi = self._cols("status", "worker_id", "end_time",
                                     "bytes_in")
        m = (wid == worker) & (st == int(Status.FINISHED)) \
            & (te >= now - horizon)
        idx = np.nonzero(m)[0]
        # every selected row is FINISHED, so the old lexsort's status
        # tie-break key was dead weight: plain stable argsort on -bytes_in
        # yields the identical permutation with one key pass
        order = np.argsort(-bi[idx], kind="stable")
        return idx[order]

    # Q3: node(s) with most aborted/failed in last minute
    def q3_worst_nodes(self, now: float, horizon: float = 60.0) -> np.ndarray:
        st, wid, te = self._cols("status", "worker_id", "end_time")
        m = (st == int(Status.FAILED)) & (te >= now - horizon)
        if not m.any():
            return np.empty(0, np.int64)
        counts = np.bincount(wid[m], minlength=self.wq.num_workers)
        return np.nonzero(counts == counts.max())[0]

    # Q4: tasks left
    def q4_tasks_left(self) -> int:
        st = self._store().col("status")
        return int(np.isin(st, [int(Status.READY), int(Status.RUNNING),
                                int(Status.BLOCKED)]).sum())

    # Q5: activity with most unfinished tasks
    def q5_worst_activity(self) -> Tuple[int, int]:
        st, act = self._cols("status", "activity_id")
        m = np.isin(st, [int(Status.READY), int(Status.RUNNING),
                         int(Status.BLOCKED)])
        if not m.any():
            return -1, 0
        counts = np.bincount(act[m])
        return int(np.argmax(counts)), int(counts.max())

    # Q6: avg/max exec time per unfinished activity
    def q6_activity_times(self) -> Dict[int, Tuple[float, float]]:
        """Loop-free sweep: per-activity mean via bincount segment sums and
        per-activity max via sorted-segment ``maximum.reduceat`` — one sort
        of the finished rows replaces a full-store re-mask per open
        activity."""
        st, act, t0, t1 = self._cols("status", "activity_id", "start_time",
                                     "end_time")
        fin = st == int(Status.FINISHED)
        open_acts = np.unique(act[np.isin(
            st, [int(Status.READY), int(Status.RUNNING)])])
        af = act[fin]
        if not (af.size and open_acts.size):
            return {}
        d = t1[fin] - t0[fin]
        order = np.argsort(af, kind="stable")
        sa, sd = af[order], d[order]
        starts = np.nonzero(np.r_[True, sa[1:] != sa[:-1]])[0]
        seg_act = sa[starts]
        seg_cnt = np.diff(np.r_[starts, sa.size])
        seg_sum = np.add.reduceat(sd, starts)
        seg_max = np.maximum.reduceat(sd, starts)
        keep = np.isin(seg_act, open_acts)
        out = {int(a): (float(s / c), float(m))
               for a, s, c, m in zip(seg_act[keep], seg_sum[keep],
                                     seg_cnt[keep], seg_max[keep])}
        return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))

    # Q7: provenance join — outputs of activity A where activity B's f1 > thr
    # and B's task took longer than B's average
    def q7_provenance_join(self, act_a: int = 0, act_b: int = 2,
                           thr: float = 0.5) -> np.ndarray:
        """Vectorized provenance walk: all hits step one parent edge per
        pass via the precomputed id->row index (O(depth) gathers instead of
        a Python while-loop per hit)."""
        v = self._store()
        st, act, t0, t1 = self._cols("status", "activity_id", "start_time",
                                     "end_time")
        f1 = v.col("out0")
        parent = v.col("parent_task")
        fin_b = (st == int(Status.FINISHED)) & (act == act_b)
        if not fin_b.any():
            return np.empty(0, np.int64)
        dur = t1 - t0
        slow = dur > np.nanmean(dur[fin_b])
        hits = np.nonzero(fin_b & (f1 > thr) & slow)[0]
        if not len(hits):
            return np.empty(0, np.int64)
        id_to_row = v.id_index()
        cur = hits.astype(np.int64)
        while True:
            safe = np.maximum(cur, 0)
            walk = (cur >= 0) & (act[safe] > act_a) & (parent[safe] >= 0)
            if not walk.any():
                break
            pid = parent[cur[walk]]
            inb = pid < id_to_row.shape[0]
            cur[walk] = np.where(
                inb, id_to_row[np.minimum(pid, id_to_row.shape[0] - 1)], -1)
        ok = (cur >= 0) & (act[np.maximum(cur, 0)] == act_a)
        return cur[ok]

    # Q8: ADAPT — patch inputs of READY tasks of an activity (user steering)
    def q8_patch_ready(self, activity: int, col: str, value: float,
                       predicate: Optional[Callable[[np.ndarray], np.ndarray]]
                       = None) -> int:
        store = self.wq.store                 # transactional: live store only
        with store.txn():
            st = store.col("status")
            act = store.col("activity_id")
            m = (st == int(Status.READY)) & (act == activity)
            if predicate is not None:
                m &= predicate(store.col(col))
            idx = np.nonzero(m)[0]
            if len(idx):
                store.update(idx, **{col: value})
                self.wq.log.append("steer_patch",
                                   {"activity": activity, "col": col,
                                    "n": len(idx), "rows": idx,
                                    "value": float(value)},
                                   store_version=store.version)
        return len(idx)

    # data reduction (paper [49]): prune READY/BLOCKED tasks by predicate
    def prune(self, predicate_col: str, lo: float, hi: float) -> int:
        store = self.wq.store                 # transactional: live store only
        with store.txn():
            st = store.col("status")
            vals = store.col(predicate_col)
            m = np.isin(st, [int(Status.READY), int(Status.BLOCKED)]) \
                & (vals >= lo) & (vals <= hi)
            idx = np.nonzero(m)[0]
            # the status write (and its ready-count + txn-log bookkeeping)
            # belongs to the WorkQueue; steering only owns the predicate
            return self.wq.prune(idx)

    # ------------------------------------------------------------ on-device
    def device_monitor(self) -> Dict[str, float]:
        """Same aggregations with torch over the device mirror (HTAP on-chip).

        The mirror is cut from the pinned snapshot when inside a sweep, so
        on-device analytics see the same version as the host queries. It
        lives on the queue's device; times stay float64.
        """
        import torch
        dv = self._store().device_view(["status", "worker_id", "start_time",
                                        "end_time"], device=self.wq.device)
        st = dv["status"]
        fin = (st == int(Status.FINISHED))
        run = (st == int(Status.RUNNING))
        dur = torch.where(fin, dv["end_time"] - dv["start_time"], 0.0)
        n_fin = fin.sum()
        return {
            "finished": int(n_fin),
            "running": int(run.sum()),
            "mean_task_s": float(dur.sum() / torch.clamp(n_fin, min=1)),
        }

    def run_all(self, now: float,
                view: Optional[SnapshotView] = None) -> Dict[str, object]:
        """One steering sweep (the paper runs the full set every 15 s).

        The whole sweep executes against ONE snapshot version (pass ``view``
        to analyze a snapshot taken earlier, e.g. mid-claim); claims proceed
        on the live store concurrently.
        """
        if view is not None or self.use_snapshots:
            ctx = self.snapshot_scope(view)
        else:
            ctx = contextlib.nullcontext(self.wq.store)
        with trace.span("steer.sweep"), ctx as v:
            return {
                "q1": self.q1_recent_status_by_node(now),
                "q3": self.q3_worst_nodes(now).tolist(),
                "q4": self.q4_tasks_left(),
                "q5": self.q5_worst_activity(),
                "q6": self.q6_activity_times(),
                "q7": self.q7_provenance_join().tolist(),
                "version": getattr(v, "version", self.wq.store.version),
            }
