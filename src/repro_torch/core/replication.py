"""Delta replication: replica catch-up by txn-log replay (paper Section 3.2).

The paper keeps one replica per partition so a data-node crash loses nothing,
and reports tens-of-MB metadata for 100k-task workloads — small enough to
ship incrementally. :class:`DeltaReplicator` implements exactly that: the
replica is a mutable store restored from a ``snapshot_view()`` once, then
caught up by replaying ``TxnLog.tail_for_version`` records — apply-ops for
every op the WorkQueue emits (insert/add_tasks, claim, claim_all, finish,
fail, requeue_worker, resize, steering patches/prunes). ``sync`` cost is
O(delta records), independent of store size; the old full-snapshot copy is
preserved as :class:`FullCopyReplica`, the O(store) baseline the
``e_replica_lag`` benchmark measures against.

Because the store is append-only (rows are never deleted or compacted),
primary row indices are valid verbatim on any replica that replayed the same
log prefix — payload row indices ARE the replica addresses, no id remapping.
Replayed record versions pin ``store.version`` to the primary's committed
version, so a caught-up replica at version v is bit-identical to a primary
``snapshot_view()`` at v (sweep parity is asserted in tests and the
e_replica_lag experiment).

Batched replay
--------------
Real logs are dominated by long runs of same-op records (claims and finishes
— the paper's Experiment 6 op inventory). :func:`replay` coalesces each
consecutive same-op run into ONE vectorized ``store.update`` (rows
concatenated, per-record scalars repeated per row), so replay cost scales
with the number of RUNS, not records. Safe because within a run the touched
rows are disjoint by the status machine (a row cannot be claimed/finished/
failed twice without an intervening record of a different op), and NumPy
fancy-index assignment applies duplicates last-wins in log order anyway.
:func:`replay_reference` keeps the record-at-a-time loop as the equivalence
oracle (property-tested bit-identical, and the denominator of the
bench-trajectory replay-throughput gate).

The raw-pointer side table (``store.blobs``) is copied at restore time but
NOT delta-shipped: like the paper, raw files stay out of the DBMS and out of
the replication stream.

Replicas are registered txn-log CONSUMERS: every ``sync`` acks the consumed
offset, so ``TxnLog.truncate`` can drop the prefix all replicas (and the
checkpointer) are past — bounding long-run log memory without ever dropping
a record a lagging replica still needs.
"""
from __future__ import annotations

import abc
import concurrent.futures
import itertools
import multiprocessing
import os
import pickle
import queue
import struct
import threading
import time
import traceback
import weakref
from collections import deque
from operator import attrgetter, itemgetter
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core import transport as transport_mod
from repro_torch.core import wire
from repro_torch.core.schema import Status
from repro_torch.core.store import ColumnStore
from repro_torch.core.transactions import LogCompactedError, Txn, plane_run
from repro_torch.core.workqueue import WorkQueue


# --------------------------------------------------------------- apply ops
def _apply_insert(store: ColumnStore, p: Dict) -> None:
    idx = store.insert(p["rows"])
    # append-only determinism: replayed rows must land exactly where the
    # primary put them, else every later payload's row indices are garbage
    if len(idx) and int(idx[0]) != int(p["row_idx"][0]):
        raise RuntimeError(
            f"replica diverged: insert replayed at row {int(idx[0])}, "
            f"primary committed at {int(p['row_idx'][0])}")
    exp = p.get("expanded_rows")
    if exp is not None and len(exp):
        store.update(exp, expanded=1)


def _apply_claim(store: ColumnStore, p: Dict) -> None:
    # lease stamps are DERIVED, not shipped: expires_at = now + the lease
    # duration carried on the restored store snapshot, the same float64 op
    # the primary ran — so lease columns stay bit-identical with zero new
    # wire fields (claim frames still carry only rows/now/worker)
    w = int(p["worker"])
    store.update(p["rows"], status=int(Status.RUNNING), start_time=p["now"],
                 worker_id=w, core_id=w, claimed_at=p["now"],
                 heartbeat_at=p["now"],
                 expires_at=p["now"] + store.lease_s)


def _apply_claim_all(store: ColumnStore, p: Dict) -> None:
    store.update(p["rows"], status=int(Status.RUNNING), start_time=p["now"],
                 claimed_at=p["now"], heartbeat_at=p["now"],
                 expires_at=p["now"] + store.lease_s)


def _apply_finish(store: ColumnStore, p: Dict) -> None:
    store.update(p["rows"], status=int(Status.FINISHED), end_time=p["now"],
                 heartbeat_at=p["now"])
    dom = p.get("domain_out")
    if dom is not None:
        store.update(p["rows"], **{f"out{i}": dom[:, i]
                                   for i in range(dom.shape[1])})


def _apply_fail(store: ColumnStore, p: Dict) -> None:
    store.update(p["rows"], fail_trials=p["trials"])
    if len(p["retry"]):
        store.update(p["retry"], status=int(Status.READY))
    if len(p["dead"]):
        store.update(p["dead"], status=int(Status.FAILED),
                     end_time=p["now"])


def _apply_requeue(store: ColumnStore, p: Dict) -> None:
    store.update(p["rows"], status=int(Status.READY),
                 fail_trials=p["trials"], worker_id=p["new_worker"])


def _apply_resize(store: ColumnStore, p: Dict) -> None:
    if len(p["rows"]):
        store.update(p["rows"], worker_id=p["assign"])


def _apply_steer_patch(store: ColumnStore, p: Dict) -> None:
    store.update(p["rows"], **{p["col"]: p["value"]})


def _apply_steer_prune(store: ColumnStore, p: Dict) -> None:
    store.update(p["rows"], status=int(Status.PRUNED))


def _apply_reap(store: ColumnStore, p: Dict) -> None:
    store.update(p["rows"], fail_trials=p["trials"])
    if len(p["retry"]):
        store.update(p["retry"], status=int(Status.READY),
                     claimed_at=np.nan, heartbeat_at=np.nan,
                     expires_at=np.nan)
        # reaped retries are rehashed onto the CURRENT partition map (the
        # reaper may run after a resize); older logs lack the key
        new_worker = p.get("new_worker")
        if new_worker is not None:
            store.update(p["retry"], worker_id=new_worker)
    if len(p["dead"]):
        store.update(p["dead"], status=int(Status.FAILED),
                     end_time=p["now"])


def _apply_lease_renew(store: ColumnStore, p: Dict) -> None:
    store.update(p["rows"], heartbeat_at=p["now"],
                 expires_at=p["now"] + store.lease_s)


_APPLY = {
    "insert": _apply_insert,
    "claim": _apply_claim,
    "claim_all": _apply_claim_all,
    "finish": _apply_finish,
    "fail": _apply_fail,
    "requeue_worker": _apply_requeue,
    "resize": _apply_resize,
    "steer_patch": _apply_steer_patch,
    "steer_prune": _apply_steer_prune,
    # lease ops are rare (one reap per expiry sweep, renewals batched per
    # heartbeat tick): cold-path records, no plane/batch fast path needed
    "reap": _apply_reap,
    "lease_renew": _apply_lease_renew,
}


# --------------------------------------------------------------- batch ops
# Builders are deliberately lean: payload row arrays are concatenated as-is
# (they are frozen int64 ndarrays by construction — _freeze copies, never
# re-types), per-record scalars stream through np.fromiter, and the repeat
# out to row counts collapses to the scalar vector itself when every record
# in the run wrote one row (per-worker claims, per-task finishes — the
# dominant shape). Per-record Python cost is what the >=10x replay gate
# measures, so every avoidable per-record allocation here is load-bearing.
def _scalar_per_row(ps: Sequence[Dict], key: str, dtype,
                    lens: Optional[np.ndarray]) -> np.ndarray:
    vals = np.fromiter(map(itemgetter(key), ps), dtype, len(ps))
    # lens is None for all-single-row runs (the dominant shape): the scalar
    # vector IS the per-row vector, no repeat needed
    return vals if lens is None else np.repeat(vals, lens)


def _run_rows(ps: Sequence[Dict], key: str = "rows"):
    """(concatenated row indices, per-record lengths) for one same-op run.

    Returns ``lens=None`` when every record wrote exactly one row, the
    common case for per-worker claims / per-task finishes — callers then
    skip the repeat entirely. The check is exact: empty records make
    ``rows.size == len(ps)`` alias, so the per-record lengths are compared,
    not the total.
    """
    rows_list = list(map(itemgetter(key), ps))
    lens = np.fromiter(map(len, rows_list), np.int64, len(rows_list))
    if bool(np.all(lens == 1)):
        return np.fromiter(map(itemgetter(0), rows_list), np.int64,
                           len(rows_list)), None
    return np.concatenate(rows_list), lens


def _batch_claim(store: ColumnStore, ps: Sequence[Dict]) -> None:
    rows, lens = _run_rows(ps)
    now = _scalar_per_row(ps, "now", np.float64, lens)
    w = _scalar_per_row(ps, "worker", np.int32, lens)
    store.update(rows, status=int(Status.RUNNING), start_time=now,
                 worker_id=w, core_id=w, claimed_at=now, heartbeat_at=now,
                 expires_at=now + store.lease_s)


def _batch_claim_all(store: ColumnStore, ps: Sequence[Dict]) -> None:
    rows, lens = _run_rows(ps)
    now = _scalar_per_row(ps, "now", np.float64, lens)
    store.update(rows, status=int(Status.RUNNING), start_time=now,
                 claimed_at=now, heartbeat_at=now,
                 expires_at=now + store.lease_s)


def _batch_finish(store: ColumnStore, ps: Sequence[Dict]) -> None:
    rows, lens = _run_rows(ps)
    now = _scalar_per_row(ps, "now", np.float64, lens)
    store.update(rows, status=int(Status.FINISHED), end_time=now,
                 heartbeat_at=now)
    dom_ps = [p for p in ps if p.get("domain_out") is not None]
    if dom_ps:
        width = dom_ps[0]["domain_out"].shape[1]
        if all(p["domain_out"].shape[1] == width for p in dom_ps):
            drows, _ = _run_rows(dom_ps)
            dom = np.concatenate(list(map(itemgetter("domain_out"), dom_ps)))
            store.update(drows, **{f"out{i}": dom[:, i]
                                   for i in range(dom.shape[1])})
        else:
            # mixed output widths across the run: concatenation would raise,
            # so the (disjoint) dom sub-updates apply record by record
            for p in dom_ps:
                d = p["domain_out"]
                store.update(p["rows"], **{f"out{i}": d[:, i]
                                           for i in range(d.shape[1])})


def _batch_fail(store: ColumnStore, ps: Sequence[Dict]) -> None:
    rows, _ = _run_rows(ps)
    trials = np.concatenate(list(map(itemgetter("trials"), ps)))
    store.update(rows, fail_trials=trials)
    retry = np.concatenate(list(map(itemgetter("retry"), ps)))
    if retry.size:
        store.update(retry, status=int(Status.READY))
    dead_ps = [p for p in ps if len(p["dead"])]
    if dead_ps:
        dead, dlens = _run_rows(dead_ps, "dead")
        now = _scalar_per_row(dead_ps, "now", np.float64, dlens)
        store.update(dead, status=int(Status.FAILED), end_time=now)


def _batch_steer_prune(store: ColumnStore, ps: Sequence[Dict]) -> None:
    store.update(np.concatenate([p["rows"] for p in ps]),
                 status=int(Status.PRUNED))


# Ops whose consecutive runs coalesce into one vectorized update. insert
# keeps its per-record row-alignment check; steer_patch records can target
# different columns; requeue/resize are rare — all stay record-at-a-time.
_BATCH = {
    "claim": _batch_claim,
    "claim_all": _batch_claim_all,
    "finish": _batch_finish,
    "fail": _batch_fail,
    "steer_prune": _batch_steer_prune,
}


# --------------------------------------------------------- hot-plane slices
# The TxnLog accumulates claims/claim_alls/finishes into columnar planes at
# append time (_HotPlane), so a consecutive run replays as O(1) array
# slices: zero per-record payload reconstruction — the per-record Python
# toll the dict-extraction batchers above still pay. Run eligibility
# (contiguity, truncation survival) is transactions.plane_run, shared with
# the wire codec so replay and shipping route runs identically.
def _plane_fields(plane, lo: int, hi: int):
    off = plane.off.view(lo, hi + 1)
    rows = plane.rows.view(int(off[0]), int(off[-1]))
    lens = np.diff(off)
    nowv = plane.now.view(lo, hi)
    single = bool(np.all(lens == 1))
    return rows, lens, (nowv if single else np.repeat(nowv, lens)), single


def _plane_claim(store: ColumnStore, plane, lo: int, hi: int) -> None:
    rows, lens, now, single = _plane_fields(plane, lo, hi)
    wv = plane.worker.view(lo, hi)
    w = wv if single else np.repeat(wv, lens)
    store.update(rows, status=int(Status.RUNNING), start_time=now,
                 worker_id=w, core_id=w, claimed_at=now, heartbeat_at=now,
                 expires_at=now + store.lease_s)


def _plane_claim_all(store: ColumnStore, plane, lo: int, hi: int) -> None:
    rows, _, now, _ = _plane_fields(plane, lo, hi)
    store.update(rows, status=int(Status.RUNNING), start_time=now,
                 claimed_at=now, heartbeat_at=now,
                 expires_at=now + store.lease_s)


def _plane_finish(store: ColumnStore, plane, lo: int, hi: int) -> bool:
    """Returns False when the dom sub-update can't be served off the plane
    (mixed dom/no-dom rows, or width-drifted carriers whose dom rows never
    entered the buffer) — caller falls back for THIS run only."""
    doff = plane.dom_off.view(lo, hi + 1)
    d0, d1 = int(doff[0]), int(doff[-1])
    rows, _, now, _ = _plane_fields(plane, lo, hi)
    if d1 > d0:
        if d1 - d0 != rows.size:          # mixed dom/no-dom rows in the run
            return False
    elif int(plane.dom_flag.view(lo, hi).sum()):
        return False                      # carriers hidden by width drift
    store.update(rows, status=int(Status.FINISHED), end_time=now,
                 heartbeat_at=now)
    if d1 > d0:         # every written row carries domain outputs
        dom = plane.dom.view(d0, d1)
        store.update(rows, **{f"out{i}": dom[:, i]
                              for i in range(dom.shape[1])})
    return True


def _apply_plane(store: ColumnStore, op: str, plane, lo: int,
                 hi: int) -> bool:
    if op == "claim":
        _plane_claim(store, plane, lo, hi)
    elif op == "claim_all":
        _plane_claim_all(store, plane, lo, hi)
    elif op == "finish":
        return _plane_finish(store, plane, lo, hi)
    else:
        return False
    return True


def _run_via_plane(store: ColumnStore, op: str, recs: Sequence[Txn]) -> bool:
    sl = plane_run(recs)
    if sl is None:
        return False
    plane, lo, hi = sl
    return _apply_plane(store, op, plane, lo, hi)


def replay_reference(store: ColumnStore, records: Iterable[Txn]) -> int:
    """Record-at-a-time replay — the equivalence ORACLE for :func:`replay`.

    After each record the store's committed version is pinned to the
    record's ``store_version`` — multi-write ops bump the replica's counter
    differently than the primary's, and the pin re-aligns them.
    Returns the number of records applied.
    """
    n = 0
    for rec in records:
        try:
            op = _APPLY[rec.op]
        except KeyError:
            raise ValueError(f"no apply-op for txn log record {rec.op!r}; "
                             "DeltaReplicator cannot replay it") from None
        op(store, rec.payload)
        store.set_version(rec.store_version)
        n += 1
    return n


def replay(store: ColumnStore, records: Iterable[Txn],
           progress: Optional[Callable[[Sequence[Txn]], None]] = None) -> int:
    """Apply a txn-log delta onto a (restored) store, in log order, with
    consecutive same-op runs coalesced into one vectorized update each.

    Bit-identical to :func:`replay_reference` (property-tested): within a
    run the status machine guarantees disjoint rows, and duplicate indices
    would apply last-wins in log order regardless. The version pin lands on
    the LAST record of each run — intermediate versions are unobservable
    inside a single replay call. Returns the number of records applied.

    ``progress`` (when given) is invoked with each applied-and-version-
    pinned batch of records — per run on the vectorized path, per record on
    the fallback path. It is the commit hook consumers use to keep their
    offset/bytes accounting TRANSACTIONAL with the applied prefix: if a
    later record raises, everything already passed to ``progress`` is
    durably applied and must not be replayed (or re-counted) on retry.
    """
    n = 0
    for op, run in itertools.groupby(records, key=attrgetter("op")):
        recs = list(run)
        batch = _BATCH.get(op)
        if batch is not None and len(recs) > 1:
            # hot planes first (O(1) slices of the log's columnar buffers);
            # dict-payload extraction covers everything the planes can't
            if not _run_via_plane(store, op, recs):
                batch(store, list(map(attrgetter("payload"), recs)))
            store.set_version(recs[-1].store_version)
            n += len(recs)
            if progress is not None:
                progress(recs)
        else:
            try:
                fn = _APPLY[op]
            except KeyError:
                raise ValueError(
                    f"no apply-op for txn log record {op!r}; "
                    "DeltaReplicator cannot replay it") from None
            for rec in recs:
                fn(store, rec.payload)
                store.set_version(rec.store_version)
                n += 1
                if progress is not None:
                    progress((rec,))
    return n


def replay_runs(store: ColumnStore, runs) -> int:
    """Run-level replay of :func:`repro_torch.core.wire.decode_delta_runs`
    output — the replica child's D-message hot path.

    Bit-identical to ``replay(store, decode_delta(buf))`` (shared plane
    serving, property-tested parity): hot frames apply straight off their
    receive plane with NO per-record object materialization — the
    dominant decode+replay cost on bulk catch-ups — and fall back to the
    record paths only for the shapes the plane cannot serve (single
    records, non-servable finish runs, cold frames)."""
    n = 0
    for dr in runs:
        if dr.plane is not None and dr.n > 1:
            if not _apply_plane(store, dr.op, dr.plane, 0, dr.n):
                _BATCH[dr.op](store,
                              [r.payload for r in dr.materialize()])
            store.set_version(dr.last_version)
            n += dr.n
        else:
            for rec in (dr.recs if dr.recs is not None
                        else dr.materialize()):
                try:
                    fn = _APPLY[rec.op]
                except KeyError:
                    raise ValueError(
                        f"no apply-op for txn log record {rec.op!r}; "
                        "DeltaReplicator cannot replay it") from None
                fn(store, rec.payload)
                store.set_version(rec.store_version)
                n += 1
    return n


_replica_seq = itertools.count()


class AllReplicasDeadError(RuntimeError):
    """Raised by :meth:`ReplicaGroup.elect` / :meth:`ReplicaGroup.promote`
    when every member's process is dead: there is no survivor whose live
    state can be trusted past its last ack, so election would crown a
    corpse. Callers that CAN restart from a durable snapshot should do so
    explicitly (Checkpointer.restore), not through promote()."""


class Replicator(abc.ABC):
    """The one replication surface the executor (and everything above it)
    programs against — the API consolidation of the four arms that accreted
    over PRs 2-5: :class:`DeltaReplicator`, :class:`ShippedDeltaReplicator`,
    :class:`ReplicaGroup`, :class:`FullCopyReplica`.

    Contract:

    * ``sync(upto_version=None)`` catches the replica up, forward-only;
      with ``upto_version`` the replica lands exactly AT that committed
      store version when the call returns. Pipelined arms may return at
      ENQUEUE for the plain ``sync()`` — ``sync(upto_version=...)`` and
      :meth:`flush` are the barriers.
    * ``lag()`` / ``maybe_sync()`` — records behind, and the cadence
      helper bounding it by ``sync_every``.
    * ``recover()`` materializes a consistent :class:`WorkQueue` after
      primary loss; ``promote()`` is recover + release.
    * ``close()`` releases everything (consumer registrations, replica
      processes, shipper threads). Idempotent; never hangs; never raises.
    * ``stats()`` is the uniform observability dict benchmarks read.

    Construct concrete replicators through :func:`make_replicator`; only
    tests and benchmarks reach for the classes directly.
    """

    sync_every: int = 64

    @abc.abstractmethod
    def sync(self, upto_version: Optional[int] = None) -> int:
        """Catch up; returns records shipped/applied/staged this call."""

    @abc.abstractmethod
    def lag(self) -> int:
        """Log records the replica is behind the primary."""

    @abc.abstractmethod
    def recover(self) -> WorkQueue:
        """Materialize a consistent WorkQueue from the replica."""

    @abc.abstractmethod
    def close(self) -> None:
        """Release replica resources. Idempotent; never hangs."""

    def maybe_sync(self) -> bool:
        """Sync when lag reached ``sync_every`` — the cadence helper."""
        if self.lag() >= self.sync_every:
            self.sync()
            return True
        return False

    def flush(self) -> None:
        """Barrier for pipelined arms: returns once every enqueued delta
        is shipped AND acked, re-raising any background ship error.
        Synchronous arms are always flushed — the default is a no-op."""

    def promote(self) -> WorkQueue:
        """Failover: the recovered WorkQueue becomes the primary and the
        replica's resources are released."""
        wq = self.recover()
        self.close()
        return wq

    def stats(self) -> Dict[str, float]:
        """Uniform observability counters (benchmark/operator surface)."""
        return {
            "records_applied": int(getattr(self, "records_applied", 0)),
            "encoded_bytes": int(getattr(self, "encoded_bytes", 0)),
            "sync_count": int(getattr(self, "sync_count", 0)),
            "lag": int(self.lag()),
            "fanout_lag_s": 0.0,
        }


class DeltaReplicator(Replicator):
    """Replica catch-up by incremental txn-log replay.

    Restores a mutable shadow store from one ``snapshot_view()`` at
    construction, then every ``sync`` replays only the log tail appended
    since — O(delta), not O(store). ``recover`` rebuilds a consistent
    WorkQueue after primary loss (RUNNING tasks return to READY, their
    workers are presumed dead — the same semantics as requeue).

    Accounting for the e_replica_lag experiment: ``delta_bytes`` sums the
    payload sizes of the applied records (the in-memory cost model);
    ``encoded_bytes`` sums their exact wire-codec frame sizes (what a NIC
    would carry — :func:`repro_torch.core.wire.frames_nbytes`); ``full_copy_bytes``
    sums what a full-snapshot sync at each of the same sync points would
    have shipped (n_rows x row_nbytes), the baseline cost this subsystem
    removes. All three advance TRANSACTIONALLY with the consumed offset
    (via replay's progress hook): a sync that raises mid-tail has counted
    exactly the records it durably applied, so a retry resumes at the
    failure point instead of re-applying — and re-counting — the prefix.
    """

    def __init__(self, wq: WorkQueue, sync_every: int = 64,
                 account_encoded: bool = True):
        self.wq = wq
        self.sync_every = sync_every
        # encoded_bytes is a benchmark-facing metric (what shipping the
        # applied delta would put on a NIC); sizing it pays pickle cost for
        # cold runs, so callers that never ship (the executor's in-process
        # analyst) opt out and keep the sync hot path free of it
        self.account_encoded = account_encoded
        view = wq.store.snapshot_view()
        self.store = ColumnStore.from_view(view, wq.store.schema)
        self.store.blobs = dict(wq.store.blobs)     # side table: restore-only
        self.offset = wq.log.index_after_version(view.version)
        # registered consumer: truncate() keeps every record >= our acked
        # offset, so a lagging replica can always catch up after compaction.
        # The finalizer unregisters on GC — a dropped replica must not pin
        # the compaction floor forever (close() does it deterministically).
        self.consumer = f"replica-{next(_replica_seq)}"
        wq.log.register_consumer(self.consumer, self.offset)
        self._unregister = weakref.finalize(
            self, wq.log.unregister_consumer, self.consumer)
        self.num_workers = wq.num_workers
        self.records_applied = 0
        self.sync_count = 0
        self.delta_bytes = 0
        self.encoded_bytes = 0
        self.full_copy_bytes = 0

    # --------------------------------------------------------------- lag
    def lag(self) -> int:
        """Log records the replica is behind the primary."""
        return len(self.wq.log) - self.offset

    # -------------------------------------------------------------- sync
    def sync(self, upto_version: Optional[int] = None) -> int:
        """Catch the replica up by replaying the unconsumed log tail.

        With ``upto_version`` the replay stops at that committed store
        version (bisected, not scanned) — used to align the replica with a
        specific primary ``snapshot_view()`` for version-exact reads.
        Replication only moves FORWARD: an ``upto_version`` the replica has
        already passed is a no-op (the consumed-log cursor and the replica
        version never rewind — rewinding would re-apply records on the next
        sync). Historical reads are ``SteeringEngine.at_version``'s job.
        Returns the number of records applied.
        """
        log = self.wq.log
        if upto_version is None:
            hi = len(log)
        else:
            try:
                hi = max(log.index_after_version(upto_version), self.offset)
            except LogCompactedError:
                # the target version predates the compaction horizon, which
                # the consumer floor guarantees we are already past: the
                # forward-only clamp would have produced a no-op anyway
                hi = self.offset
        recs = log.slice(self.offset, hi)
        applied_recs: List[Txn] = []

        def committed(run: Sequence[Txn]) -> None:
            # replay's commit hook: these records are durably applied, so
            # the consumed offset and the bytes counters advance together —
            # a raise later in the tail leaves them counted exactly once,
            # and the retry's log.slice starts past them (the regression
            # the old post-replay accounting loop double-paid)
            self.offset += len(run)
            applied_recs.extend(run)
            for r in run:
                if r.op == "resize":            # topology rides the log too
                    self.num_workers = int(r.payload["workers"])
                self.delta_bytes += r.payload_nbytes()
            self.records_applied += len(run)

        try:
            applied = replay(self.store, recs, progress=committed)
        finally:
            # ack whatever prefix was applied even on a mid-tail raise:
            # compaction may safely drop records this replica consumed.
            # Encoded bytes are sized over the whole applied prefix at once
            # so cold runs frame exactly as the encoder would ship them
            # (per-callback sizing would charge one frame per record)
            if self.account_encoded:
                self.encoded_bytes += wire.frames_nbytes(applied_recs)
            log.ack(self.consumer, self.offset)
        if upto_version is not None and upto_version > self.store.version:
            # caller vouches the log is complete through upto_version (all
            # writes used the logged API); pin even if the last record
            # committed earlier, so view.version == primary snapshot version
            # (forward only — never rewind past already-applied state)
            self.store.set_version(upto_version)
        self.sync_count += 1
        self.full_copy_bytes += self.store.n_rows * self.store.row_nbytes()
        return applied

    def snapshot_view(self):
        """Immutable view of the replica at its caught-up version — what an
        analyst thread hands to ``SteeringEngine.run_all`` so analytical
        sweeps never touch the primary's arrays at all."""
        return self.store.snapshot_view()

    def close(self) -> None:
        """Drop the consumer registration so the log may compact past us."""
        self._unregister()       # idempotent; detaches the GC finalizer too

    # ----------------------------------------------------------- recovery
    def recover(self) -> WorkQueue:
        """Rebuild a WorkQueue from the replica after primary loss: catch up
        on the surviving log tail, return RUNNING tasks to READY (their
        workers are presumed lost) — same semantics as requeue after node
        failure. The replica store BECOMES the new primary store."""
        self.sync()
        store = self.store
        st = store.col("status")
        running = np.nonzero(st == int(Status.RUNNING))[0]
        if len(running):
            store.update(running, status=int(Status.READY))
        wq = WorkQueue(self.num_workers, store=store, device=self.wq.device)
        wq._next_task_id = int(store.col("task_id").max() + 1) \
            if store.n_rows else 0
        return wq


# Backwards-compatible name: the per-partition replica of PR 0/1, now
# delta-fed. Callers that used ReplicaSet(wq).sync()/recover() keep working
# with sync cost dropped from O(store) to O(delta).
ReplicaSet = DeltaReplicator


# ------------------------------------------------------- cross-process wire
# Control tags of the replica wire protocol. Every parent request gets
# exactly one reply; deltas are the only bulk payload and ship as wire
# frames (repro_torch.core.wire), not pickles. The protocol is TRANSPORT-
# AGNOSTIC: it needs only the framed send/recv of
# :class:`repro_torch.core.transport.Transport`, so the same replica process
# serves over a multiprocessing pipe or a TCP socket (another host)
# unchanged.
#   parent -> child:  I init (snapshot + hello features)   D delta frames
#                     S sweep request   G partial-sweep request
#                     X state fetch   P promote/recover   Q quit
#   child -> parent:  A ack(offset, version)[+ accepted features on init]
#                     R sweep result   H sweep partials (columnar)
#                     Y state   W recovered snapshot   E error (traceback)
_PIN_NONE = -(1 << 62)
_DHDR = struct.Struct("<qqq")            # lo offset, hi offset, version pin
_ACK = struct.Struct("<qq")              # absolute offset, store version

# Pipelined-shipper tuning: sentinel that stops the shipper thread, and the
# coalescing target — consecutive staged chunks merge into one D message
# until its encoded size reaches this, so tiny per-sync deltas stop paying
# one round trip each (the ship_mbps_incremental collapse of PR 5). The
# target is deliberately SMALLER than one staged chunk's encoded size on
# bulk catch-ups: big backlogs then split into several in-flight messages,
# and the remote's decode+replay of message k overlaps the encode and ack
# accounting of k+1 — one round trip per ~64 KiB costs ~nothing, while the
# overlap is where the pipelined bulk throughput comes from.
_SHIP_QUIT = object()
_COALESCE_TARGET_BYTES = 64 << 10


def _shipped_replica_main(spec) -> None:
    """Entry point of the replica OS process.

    Owns a private :class:`ColumnStore` restored from the primary's
    snapshot, applies decoded wire deltas with the same :func:`replay` the
    in-process replicator uses, and acks the ABSOLUTE log offset after each
    apply — the primary forwards that ack into ``TxnLog``'s consumer-floor
    machinery, so compaction semantics are identical across the process
    boundary. Steering sweeps (``S``) run HERE, against this process's
    store: the analyst never touches a primary array, not even a
    copy-on-write one.

    ``spec`` is the picklable transport spec (``("pipe", conn)`` or
    ``("tcp", host, port)``); the init exchange doubles as the HELLO:
    the primary offers its codec list, the reply carries the one this
    process accepted (wire frames self-describe, so decode needs no state
    — the negotiation pins what the SENDER may emit).
    """
    try:
        conn = transport_mod.child_endpoint(spec)
    except (OSError, EOFError):
        return                           # primary gone before we connected
    store: Optional[ColumnStore] = None
    num_workers = 1
    offset = 0
    # sweep wrapper cached across requests (its construction recounts READY
    # rows, O(store)); rebuilt only when the store or topology changes —
    # run_all itself reads nothing but the pinned snapshot view
    engine = None
    while True:
        try:
            msg = conn.recv_bytes()
        except (EOFError, OSError):
            return                       # primary gone: nothing to serve
        tag, body = msg[:1], msg[1:]
        try:
            if tag == b"Q":
                return
            if tag == b"I":
                snap, num_workers, offset, hello = pickle.loads(body)
                store = ColumnStore.restore(snap)
                engine = None
                accepted = wire.negotiate(hello.get("codecs", ("raw",)))
                conn.send_bytes(b"A" + _ACK.pack(offset, store.version)
                                + pickle.dumps({"codec": accepted}))
            elif tag == b"D":
                lo, hi, pin = _DHDR.unpack_from(body)
                runs = wire.decode_delta_runs(body[_DHDR.size:])
                replay_runs(store, runs)
                for dr in runs:
                    # resize is a cold op: only cold frames carry records
                    for r in (dr.recs or ()):
                        if r.op == "resize":  # topology rides the log too
                            num_workers = int(r.payload["workers"])
                            engine = None
                if pin != _PIN_NONE and pin > store.version:
                    store.set_version(pin)
                offset = hi
                conn.send_bytes(b"A" + _ACK.pack(offset, store.version))
            elif tag == b"S":
                (now,) = struct.unpack_from("<d", body)
                if engine is None:
                    from repro_torch.core.steering import SteeringEngine
                    # the replica's queue only feeds the sweep: it never
                    # claims, so it stays on the host (no torch here)
                    engine = SteeringEngine(
                        WorkQueue(num_workers, store=store, device="cpu",
                                  device_claim=False))
                res = engine.run_all(now, view=store.snapshot_view())
                conn.send_bytes(b"R" + pickle.dumps(
                    res, protocol=pickle.HIGHEST_PROTOCOL))
            elif tag == b"G":
                # partial sweep: reduce HERE, ship only the aggregates.
                # The shard merge (sharding_router.merge_partials) happens
                # on the caller across every shard's reply. delay_s models
                # the data-node RPC latency of the paper's multi-host
                # regime (same role as run_baseline's access_latency_s) —
                # slept HERE so concurrent scatters genuinely overlap it
                # and a serial shard loop genuinely pays it per shard;
                # 0.0 (the production value) is a no-op.
                now_, horizon_, delay_ = struct.unpack_from("<ddd", body)
                if delay_ > 0.0:
                    time.sleep(delay_)
                from repro_torch.core.steering import sweep_partials
                part = sweep_partials(store.snapshot_view(), num_workers,
                                      now_, horizon_)
                conn.send_bytes(b"H" + wire.encode_sweep_partial(part))
            elif tag == b"X":
                conn.send_bytes(b"Y" + pickle.dumps(
                    {"snapshot": store.snapshot(), "pid": os.getpid(),
                     "num_workers": num_workers, "offset": offset},
                    protocol=pickle.HIGHEST_PROTOCOL))
            elif tag == b"P":
                st = store.col("status")
                running = np.nonzero(st == int(Status.RUNNING))[0]
                if len(running):             # workers presumed dead with
                    store.update(running,    # the primary: requeue
                                 status=int(Status.READY))
                conn.send_bytes(b"W" + pickle.dumps(
                    (store.snapshot(), num_workers),
                    protocol=pickle.HIGHEST_PROTOCOL))
            else:
                raise ValueError(f"unknown wire control tag {tag!r}")
        except Exception:                                 # noqa: BLE001
            try:
                conn.send_bytes(b"E" + pickle.dumps(traceback.format_exc()))
            except Exception:                             # noqa: BLE001
                return


class ShippedDeltaReplicator(Replicator):
    """Delta replication across a REAL process boundary.

    The replica is a separate OS process (``spawn`` by default: a fresh
    interpreter, no shared address space) fed over a
    :class:`repro_torch.core.transport.Transport`: every ``sync`` encodes the
    unconsumed log tail with the wire codec the hello exchange negotiated
    (varint-compressed hot frames by default, raw as the fallback), ships
    the frames, and advances its consumer offset only when the remote acks
    the absolute offset back — so ``TxnLog.truncate``'s consumer-floor
    machinery bounds log memory EXACTLY as it does for in-process replicas,
    and a replica that dies mid-ship re-syncs from its last acked offset
    (respawn restores from a fresh primary snapshot, which the floor
    guarantees is at or past every un-acked record) without parity loss.

    ``transport="pipe"`` is the same-host default; ``transport="tcp"``
    runs the identical protocol over a TCP socket — loopback in tests/CI,
    any host:port in a real deployment (the ``REPRO_WIRE_TRANSPORT`` env
    var flips the default, which is how CI exercises the socket path).

    ``remote_sweep`` runs a full Q1-Q7 steering sweep inside the replica
    process and ships the result back — the executor's ``analyst="remote"``
    mode, the paper's decoupled offline-analysis path made structural.
    ``recover``/``promote`` perform failover on the remote side (RUNNING
    tasks requeue THERE) and materialize the recovered WorkQueue locally.
    :class:`ReplicaGroup` broadcasts to N of these — this class IS the
    group's N=1 special case.

    Pipelined mode (``pipelined=True``, the factory default): ``sync()``
    stages the tail (captures the log records and their hot-plane column
    views on the CALLER's thread — the log's producer thread, per the
    TxnLog threading contract) and returns at ENQUEUE; a daemon shipper
    thread encodes (once, via a shareable :class:`repro_torch.core.wire.
    DeltaEncoder`), ships with a bounded unacked window, and harvests acks
    — encode overlaps the remote's decode+replay instead of serializing
    with it. The transactional semantics are unchanged: consumer offset,
    ``log.ack`` (the compaction floor), and every byte counter advance
    ONLY on ack; the bounded queue blocks the producer when full so the
    replica lag stays bounded; ``flush()``/``sync(upto_version=...)`` are
    the barriers and the error surface (a background ship failure re-raises
    there, or on the next ``sync``). ``close``/``recover``/``promote``
    drain the queue first. Staging must stay single-producer (the same
    thread that appends to the log) — which TxnLog already requires.

    Thread contract: all wire I/O serializes on one internal lock, so the
    executor's analyst thread (sweeps) and scheduler thread (syncs) can
    share the replicator; the child services one request at a time. The
    shipper holds the lock for a whole burst, so foreign requests always
    see a clean channel between bursts.
    """

    def __init__(self, wq: WorkQueue, sync_every: int = 64,
                 start_method: str = "spawn",
                 transport: Optional[str] = None,
                 codec: Optional[wire.CodecLike] = None,
                 pipelined: bool = False, queue_depth: int = 16,
                 chunk_records: int = 2048, window: int = 4,
                 encoder: Optional[wire.DeltaEncoder] = None):
        self.wq = wq
        self.sync_every = sync_every
        self.transport = transport if transport is not None \
            else os.environ.get("REPRO_WIRE_TRANSPORT", "pipe")
        if self.transport not in ("pipe", "tcp"):
            raise ValueError(f"unknown transport {self.transport!r}")
        # what the hello OFFERS; the child's negotiate() picks the codec
        name = codec if codec is None or isinstance(codec, str) \
            else codec.name
        self._offer = list(wire.CODECS) if name is None else [name, "raw"]
        self.codec = "raw"               # negotiated name; hello fills it
        self._codec: wire.Codec = wire.as_codec("raw")
        self.consumer = f"replica-{next(_replica_seq)}"
        self._ctx = multiprocessing.get_context(start_method)
        self._mu = threading.Lock()
        self.process: Optional[multiprocessing.Process] = None
        self.tr: Optional[transport_mod.Transport] = None
        self.offset = 0
        self.replica_version = -1
        self.num_workers = wq.num_workers
        self.records_applied = 0
        self.sync_count = 0
        self.spawn_count = 0
        self.delta_bytes = 0             # payload cost model (payload_nbytes)
        self.encoded_bytes = 0           # exact bytes that crossed the wire
        self.encode_wall_s = 0.0
        self.ship_wall_s = 0.0           # send + remote decode/apply + ack
        self.pipelined = bool(pipelined)
        self.chunk_records = int(chunk_records)
        self.window = max(1, int(window))
        self.encoder = encoder if encoder is not None \
            else wire.DeltaEncoder()
        self.enq_offset = 0              # producer cursor: staged-through
        self.messages_sent = 0           # D messages (>=1 chunk coalesced)
        self._shipq: Optional[queue.Queue] = None
        self._ship_thread: Optional[threading.Thread] = None
        self._ship_error: Optional[BaseException] = None
        self._closed = False
        wq.log.register_consumer(self.consumer, 0)
        self._unregister = weakref.finalize(
            self, wq.log.unregister_consumer, self.consumer)
        with self._mu:
            self._spawn()
        self.enq_offset = self.offset
        if self.pipelined:
            self._shipq = queue.Queue(maxsize=max(2, int(queue_depth)))
            self._ship_thread = threading.Thread(
                target=self._ship_loop, name=f"{self.consumer}-shipper",
                daemon=True)
            self._ship_thread.start()

    # ------------------------------------------------------------ process
    def _spawn(self) -> None:
        """(Re)start the replica process from a fresh primary snapshot.

        The new consumer offset is the log index right after the snapshot
        version — never below the last remote ack (the snapshot is newer by
        construction), so compaction already performed against that ack
        stays sound.
        """
        snap = self.wq.store.snapshot()
        self.offset = max(self.offset,
                          self.wq.log.index_after_version(snap["version"]))
        listener = None
        if self.transport == "tcp":
            listener = transport_mod.TCPListener()
            spec = ("tcp",) + listener.address
        else:
            parent_conn, child_conn = self._ctx.Pipe()
            spec = ("pipe", child_conn)
        self.process = self._ctx.Process(
            target=_shipped_replica_main, args=(spec,),
            daemon=True, name=f"{self.consumer}-remote")
        try:
            self.process.start()
            if listener is not None:
                self.tr = listener.accept(timeout=60)
            else:
                child_conn.close()
                self.tr = transport_mod.PipeTransport(parent_conn)
        finally:
            if listener is not None:
                listener.close()
        self.spawn_count += 1
        reply = self._request(b"I" + pickle.dumps(
            (snap, self.wq.num_workers, self.offset,
             {"codecs": self._offer}),
            protocol=pickle.HIGHEST_PROTOCOL))
        _, self.replica_version = _ACK.unpack_from(reply, 1)
        hello = pickle.loads(reply[1 + _ACK.size:]) \
            if len(reply) > 1 + _ACK.size else {}
        self.codec = hello.get("codec", "raw")
        # the Codec OBJECT is resolved exactly once, here at hello time —
        # everything downstream (sync, shipper thread) holds the object,
        # not the string (satellite: no more codec= string threading)
        self._codec = wire.as_codec(self.codec)
        self.num_workers = self.wq.num_workers
        self.wq.log.ack(self.consumer, self.offset)

    def _kill(self, graceful: bool = False) -> None:
        p, t = self.process, self.tr
        self.process = None
        self.tr = None
        if t is not None:
            if graceful and p is not None and p.is_alive():
                # bounded best-effort: a dead or wedged child must never
                # hang close()/__del__ on a full pipe or closed socket
                t.try_send(b"Q", timeout=1.0)
            t.close()
        if p is not None:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)

    def _recv_reply(self, timeout: float = 120.0) -> bytes:
        """Receive one reply frame. ``E`` replies kill the child (its
        store may hold a partial apply) and surface the remote traceback.
        Split out of :meth:`_request` so the pipelined shipper can harvest
        acks for frames it sent a window ago."""
        if not self.tr.poll(timeout):
            self._kill()
            raise TimeoutError(
                f"remote replica silent for {timeout}s; killed")
        reply = self.tr.recv_bytes()
        if reply[:1] == b"E":
            detail = pickle.loads(reply[1:])
            self._kill()
            raise RuntimeError(f"remote replica failed:\n{detail}")
        return reply

    def _request(self, msg: bytes, timeout: float = 120.0) -> bytes:
        """One lockstep request/reply round trip."""
        self.tr.send_bytes(msg)
        return self._recv_reply(timeout)

    @property
    def remote_pid(self) -> Optional[int]:
        return self.process.pid if self.process is not None else None

    # --------------------------------------------------------------- lag
    def lag(self) -> int:
        """Log records the replica is behind the primary (acked, not
        merely enqueued — the pipelined cursor is ``enq_offset``)."""
        return len(self.wq.log) - self.offset

    # -------------------------------------------------------------- sync
    def sync(self, upto_version: Optional[int] = None) -> int:
        """Ship the unconsumed tail; returns #records shipped (synchronous
        mode) or staged+enqueued (pipelined mode).

        Semantics match :meth:`DeltaReplicator.sync` (forward-only,
        ``upto_version`` bisected and pinned remotely) with one addition:
        the consumer offset, byte counters, and ``log.ack`` advance only
        after the remote acks the absolute offset — accounting is
        transactional with what the replica durably consumed. A dead child
        triggers respawn-from-snapshot (the snapshot is taken after every
        staged record was appended, so it covers all of them).

        Pipelined: a plain ``sync()`` returns at enqueue (backpressure
        blocks when the bounded queue is full); ``sync(upto_version=...)``
        additionally drains the pipeline so the replica is AT the version
        when the call returns. A background ship error re-raises here.
        """
        if not self.pipelined:
            with self._mu:
                return self._sync_locked(upto_version)
        self._raise_ship_error()
        log = self.wq.log
        lo = max(self.enq_offset, self.offset)
        if upto_version is None:
            hi = len(log)
        else:
            try:
                hi = max(log.index_after_version(upto_version), lo)
            except LogCompactedError:
                hi = lo                  # already past it (consumer floor)
        n = hi - lo
        if n:
            # ONE queue item per sync: the shipper sees the whole staged
            # span in a single burst, so its unacked window pipelines
            # across every chunk instead of draining at chunk boundaries
            self._shipq.put(wire.stage_delta(
                log.slice(lo, hi), lo,
                chunk_records=self.chunk_records))  # full q -> block
            self.enq_offset = hi
        if upto_version is not None:
            # version-exact callers need the replica AT the version when
            # sync returns: drain the pipeline, then let the synchronous
            # path settle the pin-only edge under the lock
            self.flush()
            with self._mu:
                self._sync_locked(upto_version)
        return n

    # ----------------------------------------------------- pipelined shipper
    def _raise_ship_error(self) -> None:
        err, self._ship_error = self._ship_error, None
        if err is not None:
            raise err

    def flush(self) -> None:
        """Block until every enqueued chunk is shipped AND acked; this is
        the pipelined error surface (a background failure re-raises here).
        Synchronous mode is always flushed — no-op."""
        if not self.pipelined or self._shipq is None:
            return
        self._shipq.join()
        self._raise_ship_error()

    def _join_queue(self, timeout: float) -> bool:
        """``Queue.join`` with a deadline — close()'s bounded drain."""
        q = self._shipq
        deadline = time.monotonic() + timeout
        with q.all_tasks_done:
            while q.unfinished_tasks:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                q.all_tasks_done.wait(left)
        return True

    def _ship_loop(self) -> None:
        """Daemon shipper: dequeue staged syncs (each item is the chunk
        list of ONE sync call), coalesce a burst, encode once (shared
        :class:`wire.DeltaEncoder`), ship with a bounded unacked window,
        harvest acks. Every dequeued item is task_done'd exactly once —
        on success, error, or after close — so ``flush()``/``close()``
        can never hang on a lost item."""
        q = self._shipq
        while True:
            item = q.get()
            if item is _SHIP_QUIT:
                q.task_done()
                return
            burst = [item]
            quit_seen = False
            while len(burst) < 64:
                try:
                    nxt = q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _SHIP_QUIT:
                    quit_seen = True
                    break
                burst.append(nxt)
            try:
                if not self._closed:
                    self._ship_burst([c for item in burst for c in item])
            except Exception as e:                        # noqa: BLE001
                if self._ship_error is None:
                    self._ship_error = e   # flush()/next sync re-raises
            finally:
                for _ in burst:
                    q.task_done()
            if quit_seen:
                q.task_done()
                return

    def _ship_burst(self, chunks: Sequence) -> None:
        """Ship one burst under the wire lock — foreign requests (sweeps,
        fetches, recover) always see a clean channel between bursts."""
        with self._mu:
            if self.process is None or not self.process.is_alive():
                self._spawn()
            # the respawn snapshot is taken AFTER every staged record was
            # appended, so its log index is >= every enqueued hi: chunks
            # the snapshot already covers drop out here, never partially
            todo = [c for c in chunks if c.hi > self.offset]
            if not todo:
                return
            try:
                self._ship_window(todo)
            except (BrokenPipeError, EOFError, OSError):
                # died mid-ship: nothing past the last ack was consumed;
                # respawn from a fresh snapshot — the rest of this burst
                # (and the whole backlog) is inside it and will be skipped
                # by the offset filter above on the next burst
                self._kill()
                self._spawn()

    def _ship_window(self, todo: Sequence) -> None:
        """Encode-and-send with a bounded unacked window. Small consecutive
        chunks coalesce into one D message until ~_COALESCE_TARGET_BYTES of
        encoded payload (tiny per-sync deltas stop paying one round trip
        each); up to ``window`` messages ride the wire unacked, and acks
        harvest opportunistically while the next message encodes."""
        t0 = time.perf_counter()
        enc_wall = 0.0
        outstanding: deque = deque()
        i = 0
        while i < len(todo):
            group: List = []
            bufs: List = []
            g_bytes = 0
            while i < len(todo) and (not group
                                     or g_bytes < _COALESCE_TARGET_BYTES):
                c = todo[i]
                e0 = time.perf_counter()
                bufs.append(self.encoder.encode_staged(c, self._codec))
                enc_wall += time.perf_counter() - e0
                g_bytes += len(bufs[-1])
                group.append(c)
                i += 1
            lo, hi = group[0].lo, group[-1].hi
            self.tr.send_chunks(
                [b"D" + _DHDR.pack(lo, hi, _PIN_NONE)] + bufs)
            self.messages_sent += 1
            outstanding.append((hi, g_bytes, group))
            while outstanding and (len(outstanding) >= self.window
                                   or self.tr.poll(0)):
                self._harvest_one(outstanding)
        while outstanding:
            self._harvest_one(outstanding)
        self.encode_wall_s += enc_wall
        self.ship_wall_s += max(time.perf_counter() - t0 - enc_wall, 0.0)

    def _harvest_one(self, outstanding: deque) -> None:
        """Consume one ack and advance the transactional state: offset,
        compaction floor (``log.ack`` — the one TxnLog entry point that is
        cross-thread safe by contract), and the byte counters move together
        and only here."""
        hi, g_bytes, group = outstanding.popleft()
        reply = self._recv_reply()
        off, self.replica_version = _ACK.unpack_from(reply, 1)
        if off != hi:
            raise RuntimeError(
                f"remote replica acked offset {off}, expected {hi}")
        self.offset = hi
        self.wq.log.ack(self.consumer, hi)
        self.encoded_bytes += g_bytes
        n = 0
        for c in group:
            for run in c.runs:
                if run.op == "resize":   # topology rides the log too
                    self.num_workers = int(run.recs[-1].payload["workers"])
                self.delta_bytes += wire.staged_payload_nbytes(run)
                n += len(run.recs)
        self.records_applied += n
        self.sync_count += 1

    def _sync_locked(self, upto_version: Optional[int],
                     _retry: bool = True) -> int:
        log = self.wq.log
        if self.process is None or not self.process.is_alive():
            self._spawn()
        if upto_version is None:
            hi = len(log)
        else:
            try:
                hi = max(log.index_after_version(upto_version), self.offset)
            except LogCompactedError:
                hi = self.offset         # already past it (consumer floor)
        pin = _PIN_NONE
        if upto_version is not None and upto_version > self.replica_version:
            pin = int(upto_version)
        if hi == self.offset and pin == _PIN_NONE:
            return 0
        recs = log.slice(self.offset, hi)
        t0 = time.perf_counter()
        buf = self.encoder.encode_records(self.offset, hi, recs, self._codec)
        t1 = time.perf_counter()
        try:
            reply = self._request(
                b"D" + _DHDR.pack(self.offset, hi, pin) + buf)
        except (BrokenPipeError, EOFError, OSError):
            # died mid-ship: nothing past the last ack was consumed; the
            # respawn snapshot covers every un-acked record, so parity is
            # preserved — re-issue against the new offset
            if not _retry:
                raise
            self._kill()
            self._spawn()
            return self._sync_locked(upto_version, _retry=False)
        t2 = time.perf_counter()
        off, self.replica_version = _ACK.unpack_from(reply, 1)
        if off != hi:
            raise RuntimeError(
                f"remote replica acked offset {off}, expected {hi}")
        self.offset = hi
        log.ack(self.consumer, hi)
        self.encode_wall_s += t1 - t0
        self.ship_wall_s += t2 - t1
        self.encoded_bytes += len(buf)
        for r in recs:
            if r.op == "resize":
                self.num_workers = int(r.payload["workers"])
            self.delta_bytes += r.payload_nbytes()
        self.records_applied += len(recs)
        self.sync_count += 1
        return len(recs)

    # ------------------------------------------------------------ analyst
    def remote_sweep(self, now: float) -> Dict[str, object]:
        """Run a full Q1-Q7 steering sweep IN the replica process (against
        its own store at its caught-up version) and return the result.
        Pipelined shippers drain first — the sweep sees every delta that
        was enqueued before this call."""
        self.flush()
        with self._mu:
            if self.process is None or not self.process.is_alive():
                self._spawn()
            reply = self._request(b"S" + struct.pack("<d", float(now)))
            return pickle.loads(reply[1:])

    def remote_sweep_partials(self, now: float, horizon: float = 60.0,
                              delay_s: float = 0.0) -> Dict[str, object]:
        """Run `steering.sweep_partials` IN the replica process and return
        the decoded partial aggregates (bincount slabs + scalars + compact
        ancestry columns) — the shard-parallel steering plane's unit of
        work, merged across shards by `sharding_router.merge_partials`.
        Pipelined shippers drain first, so the partial is pinned at the
        last synced version (the caller hard-checks it). ``delay_s`` is
        slept remotely before the sweep — modeled data-node RPC latency
        for the latency-regime benchmarks; leave 0 in production."""
        self.flush()
        with self._mu:
            if self.process is None or not self.process.is_alive():
                self._spawn()
            reply = self._request(
                b"G" + struct.pack("<ddd", float(now), float(horizon),
                                   float(delay_s)))
            return wire.decode_sweep_partial(reply[1:])

    def fetch_remote_state(self) -> Dict[str, object]:
        """{snapshot, pid, num_workers, offset} straight from the replica
        process — the bit-parity and process-isolation evidence the
        e_wire_ship experiment hard-checks. Pipelined shippers drain
        first."""
        self.flush()
        with self._mu:
            if self.process is None or not self.process.is_alive():
                self._spawn()
            reply = self._request(b"X")
            return pickle.loads(reply[1:])

    # ----------------------------------------------------------- failover
    def recover(self) -> WorkQueue:
        """Failover: drain the surviving log tail into the replica, requeue
        its RUNNING tasks remotely, and materialize the recovered WorkQueue
        here (the replica store BECOMES the new primary store). Pipelined
        shippers drain their queue first (no enqueued record may be lost
        to the failover)."""
        if self.pipelined:
            self.sync()                  # stage whatever tail remains
            self.flush()                 # ship + ack everything enqueued
        with self._mu:
            self._sync_locked(None)      # stragglers; no-op when drained
            reply = self._request(b"P")
            snap, num_workers = pickle.loads(reply[1:])
        store = ColumnStore.restore(snap)
        wq = WorkQueue(num_workers, store=store, device=self.wq.device)
        wq._next_task_id = int(store.col("task_id").max() + 1) \
            if store.n_rows else 0
        return wq

    def close(self) -> None:
        """Quit the replica process and stop pinning the compaction floor.

        Pipelined: the queued backlog drains (ships) first with a BOUNDED
        wait, then the shipper thread stops — close never hangs on a
        wedged child and never raises (a pending background ship error is
        discarded: the replica is being released anyway). Idempotent, and
        safe after a child crash: the graceful quit is a bounded
        ``try_send`` (never blocks on a dead or full pipe), kills fall
        back to terminate, and a second close is a no-op.
        """
        t, self._ship_thread = self._ship_thread, None
        if t is not None:
            if t.is_alive():
                self._join_queue(timeout=60.0)       # bounded drain
            self._closed = True          # shipper skips anything left
            try:
                self._shipq.put(_SHIP_QUIT, timeout=5.0)
            except queue.Full:
                pass
            t.join(timeout=10.0)
            self._ship_error = None      # close never raises
        with self._mu:
            self._kill(graceful=True)
        self._unregister()       # idempotent; detaches the GC finalizer too

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        s.update(encode_wall_s=self.encode_wall_s,
                 ship_wall_s=self.ship_wall_s,
                 spawn_count=self.spawn_count,
                 messages_sent=self.messages_sent,
                 pipelined=float(self.pipelined))
        return s

    def __del__(self):
        # last-resort cleanup: must never raise or hang, even mid-interpreter
        # shutdown or after __init__ died before the process came up
        try:
            self.close()
        except Exception:                                 # noqa: BLE001
            pass


class ReplicaGroup(Replicator):
    """N-replica fan-out per partition: the paper's availability story at
    cluster scale (§4 — replica placement owned by the DBMS, one consumer
    group per partition), built by BROADCASTING the same wire deltas to N
    independent :class:`ShippedDeltaReplicator` members.

    The broadcast is ENCODE-ONCE and CONCURRENT: every member shares one
    :class:`repro_torch.core.wire.DeltaEncoder`, so a delta chunk is encoded by
    whichever member gets there first and the other N-1 ship the cached
    bytes; ``sync`` fans out on a thread pool (one thread per member), so
    broadcast wall is ~max(member), not the serial sum.

    Every member is its own registered ``TxnLog`` consumer with its own
    acked offset, so the compaction floor is min-over-group BY CONSTRUCTION
    (``TxnLog.truncate`` already takes the min across registered
    consumers): a lagging member pins exactly the prefix it still needs,
    and nothing else. ``remote_sweep`` round-robins steering sweeps across
    members (the executor's ``analyst="remote"`` load-balancing);
    ``promote`` elects the most-caught-up LIVE member (highest acked
    offset; liveness first — a dead leader's ack is still durable via the
    consumer floor, but electing it would pay a respawn) and releases the
    rest.

    With ``n_replicas=1`` this is exactly one ShippedDeltaReplicator plus
    a method veneer — the N=1 special case every pre-fabric caller keeps.
    """

    def __init__(self, wq: WorkQueue, n_replicas: int = 1,
                 sync_every: int = 64, start_method: str = "spawn",
                 transport: Optional[str] = None,
                 codec: Optional[wire.CodecLike] = None,
                 pipelined: bool = False, queue_depth: int = 16,
                 chunk_records: int = 2048, window: int = 4):
        if n_replicas < 1:
            raise ValueError("a replica group needs at least one member")
        self.wq = wq
        self.sync_every = sync_every
        # ONE encoder for the whole group: each delta chunk is encoded
        # once, every member broadcasts the same bytes
        self.encoder = wire.DeltaEncoder(max_entries=max(32, 4 * n_replicas))
        self.members: List[ShippedDeltaReplicator] = []
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        try:
            for _ in range(n_replicas):
                self.members.append(ShippedDeltaReplicator(
                    wq, sync_every=sync_every, start_method=start_method,
                    transport=transport, codec=codec, pipelined=pipelined,
                    queue_depth=queue_depth, chunk_records=chunk_records,
                    window=window, encoder=self.encoder))
            if n_replicas > 1:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=n_replicas, thread_name_prefix="fanout")
        except Exception:
            self.close()                 # no half-built group leaks processes
            raise
        self._rr = 0
        self.last_sync_wall_s: List[float] = [0.0] * n_replicas
        self.last_broadcast_wall_s = 0.0

    # N=1 veneer: callers written against ShippedDeltaReplicator (the
    # executor gotchas, notebooks) keep reading the same surface off a
    # group — per-member figures aggregate conservatively.
    @property
    def remote_pid(self) -> Optional[int]:
        """Pid of the first live member's process (see ``remote_pids``)."""
        pids = self.remote_pids
        return pids[0] if pids else None

    @property
    def remote_pids(self) -> List[int]:
        return [m.remote_pid for m in self.members
                if m.remote_pid is not None]

    @property
    def records_applied(self) -> int:
        """Records every member has durably applied (min over the group —
        the fan-out is only as caught up as its laggard)."""
        return min(m.records_applied for m in self.members)

    @property
    def encoded_bytes(self) -> int:
        """Total bytes the fan-out put on the wire (sum over members —
        a broadcast pays the delta once per replica)."""
        return sum(m.encoded_bytes for m in self.members)

    @property
    def codec(self) -> str:
        return self.members[0].codec

    # --------------------------------------------------------------- lag
    def lag(self) -> int:
        """Records the LAGGIEST member is behind (what maybe_sync bounds)."""
        return max(m.lag() for m in self.members)

    def lags(self) -> List[int]:
        """Per-member lag in log records (index-aligned with members)."""
        return [m.lag() for m in self.members]

    def fanout_lag_s(self) -> float:
        """End-to-end wall of the last broadcast ``sync`` — with the
        concurrent fan-out this is ~max(member wall), not the serial sum
        the member-by-member loop used to pay. The straggler signal
        (slowest minus fastest member) is :meth:`member_spread_s`."""
        return self.last_broadcast_wall_s

    def member_spread_s(self) -> float:
        """Slowest minus fastest member in the last broadcast — what an
        operator watches for a straggling replica."""
        return max(self.last_sync_wall_s) - min(self.last_sync_wall_s)

    # -------------------------------------------------------------- sync
    def sync(self, upto_version: Optional[int] = None) -> int:
        """Broadcast the unconsumed tail to every member CONCURRENTLY (one
        pool thread per member); returns the max records applied by any
        member (they may start at different acked offsets after respawns).
        Ack/floor semantics are per member — ``TxnLog.truncate`` keeps
        everything the slowest one still needs. The caller blocks until
        every member returned, so member-side staging reads of the log
        happen while the producer thread is parked — the TxnLog
        single-producer contract holds.
        """
        def timed(m: ShippedDeltaReplicator):
            t0 = time.perf_counter()
            n = m.sync(upto_version)
            return n, time.perf_counter() - t0
        b0 = time.perf_counter()
        if self._pool is None:
            results = [timed(m) for m in self.members]
        else:
            results = list(self._pool.map(timed, self.members))
        self.last_broadcast_wall_s = time.perf_counter() - b0
        self.last_sync_wall_s = [w for _, w in results]
        return max(n for n, _ in results)

    def flush(self) -> None:
        """Drain every member's pipeline (concurrently when pooled)."""
        if self._pool is None:
            for m in self.members:
                m.flush()
        else:
            list(self._pool.map(ShippedDeltaReplicator.flush, self.members))

    # ------------------------------------------------------------ analyst
    def remote_sweep(self, now: float) -> Dict[str, object]:
        """Q1-Q7 sweep on the next member, round-robin — N analysts share
        the steering load and no single replica process becomes the
        analytical hot spot."""
        m = self.members[self._rr % len(self.members)]
        self._rr += 1
        return m.remote_sweep(now)

    def remote_sweep_partials(self, now: float, horizon: float = 60.0,
                              delay_s: float = 0.0) -> Dict[str, object]:
        """Partial sweep on the next member, round-robin — same analyst
        load-spreading as :meth:`remote_sweep`, shipping only the partial
        aggregates (the sharded steering plane merges them)."""
        m = self.members[self._rr % len(self.members)]
        self._rr += 1
        return m.remote_sweep_partials(now, horizon, delay_s)

    # ----------------------------------------------------------- failover
    def elect(self) -> ShippedDeltaReplicator:
        """The member ``promote`` would crown: most-caught-up (highest
        acked offset, then replica version) among LIVE processes. When
        every process is dead there is no electable member — a corpse's
        store may trail its last ack arbitrarily — so this raises
        :class:`AllReplicasDeadError` instead of crowning one."""
        def key(m: ShippedDeltaReplicator):
            alive = m.process is not None and m.process.is_alive()
            return (alive, m.offset, m.replica_version)
        leader = max(self.members, key=key)
        if not (leader.process is not None and leader.process.is_alive()):
            raise AllReplicasDeadError(
                f"all {len(self.members)} replica processes are dead; "
                "nothing to promote — restore from a checkpoint instead")
        return leader

    def recover(self) -> WorkQueue:
        """Failover WITHOUT releasing the group: the elected member drains
        the surviving tail and materializes the recovered WorkQueue."""
        return self.elect().recover()

    def promote(self) -> WorkQueue:
        """Failover: promote the elected member (its replica store becomes
        the new primary) and release every other member's process."""
        leader = self.elect()
        for m in self.members:
            if m is not leader:
                m.close()
        wq = leader.promote()
        self.close()
        return wq

    def close(self) -> None:
        for m in self.members:
            m.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        s["fanout_lag_s"] = self.fanout_lag_s()
        s["member_spread_s"] = self.member_spread_s()
        s.update(self.encoder.stats())
        return s


# The fabric is the group plus the transport/codec policy baked into its
# members — one name for callers that think in topology terms.
ReplicationFabric = ReplicaGroup


class FullCopyReplica(Replicator):
    """The pre-delta baseline: every sync deep-copies the whole store.

    Kept ONLY as the comparison arm of the e_replica_lag experiment (sync
    cost grows with store size, not delta size). Not for production use.
    """

    def __init__(self, wq: WorkQueue, sync_every: int = 64):
        self.wq = wq
        self.sync_every = sync_every
        self.snapshot = wq.store.snapshot()
        self.offset = len(wq.log)
        self.sync_count = 0
        self.copy_bytes = 0

    def lag(self) -> int:
        return len(self.wq.log) - self.offset

    def sync(self, upto_version: Optional[int] = None) -> int:
        # ``upto_version`` accepted for Replicator-API parity: a full copy
        # is always at the primary's CURRENT version, which is >= any
        # committed upto_version a caller could name (forward-only holds)
        applied = self.lag()
        self.snapshot = self.wq.store.snapshot()
        self.offset = len(self.wq.log)
        self.sync_count += 1
        self.copy_bytes += (self.snapshot["n_rows"]
                            * self.wq.store.row_nbytes())
        return applied

    def recover(self) -> WorkQueue:
        store = ColumnStore.restore(self.snapshot)
        st = store.col("status")
        running = np.nonzero(st == int(Status.RUNNING))[0]
        if len(running):
            store.update(running, status=int(Status.READY))
        wq = WorkQueue(self.wq.num_workers, store=store,
                       device=self.wq.device)
        wq._next_task_id = int(store.col("task_id").max() + 1) \
            if store.n_rows else 0
        return wq

    def close(self) -> None:
        """Nothing to release: the baseline registers no log consumer and
        owns no processes — present for Replicator-API parity."""

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        s["copy_bytes"] = int(self.copy_bytes)
        return s


# ------------------------------------------------------------------ factory
def make_replicator(wq: WorkQueue, mode: str = "delta", *,
                    replicas: int = 1, sync_every: int = 64,
                    transport: Optional[str] = None,
                    codec: Optional[wire.CodecLike] = None,
                    pipelined: Optional[bool] = None,
                    start_method: str = "spawn",
                    account_encoded: bool = True) -> Replicator:
    """The one construction site for replicators — everything above the
    core (the executor's ``analyst=`` modes, benchmarks, notebooks) asks
    for a replication POLICY by name instead of hand-wiring classes.

    Modes (aliases in parentheses):

    * ``"delta"`` (``"local"``, ``"replica"``) — in-process
      :class:`DeltaReplicator`: shadow store in the same address space.
    * ``"shipped"`` — one :class:`ShippedDeltaReplicator` process;
      PIPELINED by default (pass ``pipelined=False`` for lockstep
      request/reply shipping).
    * ``"remote"`` (``"group"``, ``"fabric"``) — a :class:`ReplicaGroup`
      of ``replicas`` members; pipelined by default.
    * ``"full"`` — the :class:`FullCopyReplica` baseline (benchmark arm).

    ``transport`` ("pipe"/"tcp") and ``codec`` thread through to the
    shipped modes; ``codec`` accepts a name ("adaptive"/"varint"/"raw")
    or a :class:`repro_torch.core.wire.Codec` instance.
    """
    m = {"local": "delta", "replica": "delta",
         "group": "remote", "fabric": "remote"}.get(mode, mode)
    if m in ("delta", "full", "shipped") and replicas != 1:
        raise ValueError(
            f"mode {mode!r} is single-replica; got replicas={replicas} "
            "(use mode='remote' for a fan-out group)")
    if m == "delta":
        return DeltaReplicator(wq, sync_every=sync_every,
                               account_encoded=account_encoded)
    if m == "full":
        return FullCopyReplica(wq, sync_every=sync_every)
    if m == "shipped":
        return ShippedDeltaReplicator(
            wq, sync_every=sync_every, start_method=start_method,
            transport=transport, codec=codec,
            pipelined=True if pipelined is None else pipelined)
    if m == "remote":
        return ReplicaGroup(
            wq, n_replicas=replicas, sync_every=sync_every,
            start_method=start_method, transport=transport, codec=codec,
            pipelined=True if pipelined is None else pipelined)
    raise ValueError(f"unknown replicator mode {mode!r}")
