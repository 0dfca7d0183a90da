"""Distributed Work Queue on the column store (paper Sections 3.2-3.3).

Passive multi-master semantics: workers *claim* from their own partition
(``WHERE worker_id = i AND status = READY ORDER BY task_id LIMIT k``); the
partition-private access removes write conflicts, exactly the paper's
argument. ``claim_all`` is the batched SPMD form: one vectorized operation
claims the next task for every worker at once — this is what the executor
uses per training step and what the ``wq_claim`` CUDA kernel implements
on-device.

Claim fast-path
---------------
The paper's Experiment 6 shows getREADYtasks + the RUNNING flip dominate DBMS
time, so the hot path here is fully vectorized: ONE scan over the ready
suffix of the store (per-partition ready cursors skip the claimed prefix),
per-worker ranks via a stable worker-sort + ``np.bincount`` segment offsets,
and work stealing as one vectorized redistribution of the leftover pool onto
deficit workers — no per-worker Python loop anywhere. ``claim_all_reference``
keeps the original O(n·W) loop as the oracle for equivalence tests and the
speedup benchmark. With ``device_claim`` enabled the primary phase runs the
``wq_claim`` op on the queue's torch device instead (the CUDA kernel on a
card, its plain PyTorch version on the CPU).

Work stealing (straggler mitigation) claims from the most-loaded sibling
partition when the own partition is dry (paper: "more partitions than data
nodes gives flexibility ... load balancing").
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.partition import assign_workers, partition_sizes, rehash
from repro_torch.core.schema import LEGAL_TRANSITIONS, Status
from repro_torch.core.store import ColumnStore
from repro_torch.core.transactions import TxnLog


class WorkQueue:
    def __init__(self, num_workers: int, store: Optional[ColumnStore] = None,
                 txn_log: Optional[TxnLog] = None, capacity: int = 1 << 16,
                 device_claim: Optional[bool] = None,
                 lease_s: Optional[float] = None, device="cuda"):
        self.store = store or ColumnStore(capacity=capacity)
        if lease_s is not None:
            # lease duration rides ON THE STORE (and inside its snapshot)
            # so replicas restored from it derive identical expires_at
            # values when replaying claim records — see store.DEFAULT_LEASE_S
            self.store.lease_s = float(lease_s)
        self.num_workers = num_workers
        self.log = txn_log or TxnLog()
        self._next_task_id = int(self.store.n_rows)
        if device_claim is None:
            from repro_torch.flags import wq_device_claim
            device_claim = wq_device_claim()
        self.device_claim = bool(device_claim)
        # where the device claim runs; a queue that claims on the device
        # checks the device up front instead of at its first claim. torch
        # is imported only on that path: a queue that claims on the host (a
        # replica's, in its own process) never loads it
        if self.device_claim:
            from repro_torch.device import resolve_device
            device = resolve_device(device)
        self.device = device
        # ready cursor per partition: no READY row of partition w exists at a
        # row index < _cursor[w]. Claims advance it; any transition that can
        # re-create READY rows at lower indices lowers it again.
        self._cursor = np.zeros(num_workers, np.int64)
        # orphan watermark: min row index at which a READY row whose
        # worker_id fell outside [0, W) may exist (shrink-resize + retry).
        # No per-partition cursor covers those rows, so scans start at
        # min(cursor.min(), _orphan_lo) to keep them reachable by stealing.
        self._orphan_lo = self._NO_ORPHANS
        # exact READY count per partition (index may exceed W for partitions
        # orphaned by a shrink-resize; negative ids in a scalar bucket),
        # maintained incrementally on every status transition: _steal picks
        # its victim and claim_all bounds its block scan from these instead
        # of rescanning the ready suffix.
        self._ready = np.zeros(num_workers, np.int64)
        self._ready_neg = 0
        self._recount_ready()

    _NO_ORPHANS = np.iinfo(np.int64).max

    def scan_start(self) -> int:
        """First row the next claim scans: no claimable row lies before
        it, and a device claim launches only when rows lie past it."""
        return int(min(self._cursor.min(), self._orphan_lo))

    # --------------------------------------------------------- ready counts
    def _ready_delta(self, wids: np.ndarray, sign: int) -> None:
        """Shift per-partition READY counts for rows entering (+1) or
        leaving (-1) READY, keyed by their worker_id at that moment.
        Negative partition ids go to a scalar bucket: no partition-private
        claim or steal victim pick can reach them, but claim_all's steal
        POOL can (matching claim_all_reference), so they must still count
        toward total availability."""
        wids = np.asarray(wids)
        neg = int((wids < 0).sum())
        if neg:
            self._ready_neg += sign * neg
        w = wids[wids >= 0].astype(np.int64, copy=False)
        if not w.size:
            return
        hi = int(w.max()) + 1
        if hi > self._ready.size:
            self._ready = np.concatenate(
                [self._ready, np.zeros(hi - self._ready.size, np.int64)])
        self._ready[:hi] += sign * np.bincount(w, minlength=hi)

    def _recount_ready(self) -> None:
        """Rebuild the counts from the store (init / out-of-band mutations)."""
        st = self.store.col("status")
        rw = self.store.col("worker_id")[st == int(Status.READY)]
        self._ready_neg = int((rw < 0).sum())
        rw = rw[rw >= 0].astype(np.int64, copy=False)
        size = max(self.num_workers, int(rw.max()) + 1 if rw.size else 0)
        self._ready = np.bincount(rw, minlength=size) \
            if rw.size else np.zeros(size, np.int64)

    def ready_counts(self) -> np.ndarray:
        """READY tasks per partition (copy; length num_workers)."""
        out = np.zeros(self.num_workers, np.int64)
        n = min(self.num_workers, self._ready.size)
        out[:n] = self._ready[:n]
        return out

    # ----------------------------------------------------------- txn helper
    def _append_log(self, op: str, payload: Dict) -> None:
        self.log.append(op, payload, store_version=self.store.version)

    def compact_log(self) -> int:
        """Drop the txn-log prefix every registered consumer (checkpointer,
        replicas — each member of a replica GROUP registers independently,
        so the floor is min-over-group) has acked past — bounds long-run
        log memory. A no-op when no consumer is registered (nothing is
        provably durable elsewhere)."""
        return self.log.truncate()

    def consumer_lags(self) -> Dict[str, int]:
        """Log records each registered consumer still has to consume —
        the per-replica lag surface the replication fabric (and its
        ``fanout_lag`` benchmark metric) reports from."""
        end = len(self.log)
        return {name: end - off
                for name, off in self.log.consumer_offsets().items()}

    # -------------------------------------------------------------- cursors
    def invalidate_cursors(self, rows: Optional[np.ndarray] = None) -> None:
        """Lower the ready cursors after an out-of-band status change.

        Call with the affected rows when external code mutates ``status`` (or
        ``worker_id``) directly on the store instead of going through the
        WorkQueue API; with ``rows=None`` all cursors reset to 0.
        """
        if rows is None or len(rows) == 0:
            self._cursor[:] = 0
            self._orphan_lo = 0
        else:
            self._cursor[:] = np.minimum(self._cursor, int(np.min(rows)))
            self._orphan_lo = min(self._orphan_lo, int(np.min(rows)))
        self._recount_ready()          # counts cannot be patched blind

    def _lower_cursors(self, rows: np.ndarray, wid: np.ndarray) -> None:
        """Per-partition lower bound for rows that just became READY."""
        ok = (wid >= 0) & (wid < self.num_workers)
        if ok.any():
            np.minimum.at(self._cursor, wid[ok], rows[ok])
        if (~ok).any():                    # orphaned partition rows: tracked
            self._orphan_lo = min(self._orphan_lo,   # by the watermark, not
                                  int(np.min(rows[~ok])))    # any cursor

    # -------------------------------------------------------------- inserts
    def add_tasks(self, activity_id: int, n: int, *,
                  status: Status = Status.READY,
                  duration_est=0.0,
                  domain_in: Optional[np.ndarray] = None,
                  parent_task: Optional[np.ndarray] = None,
                  now: float = 0.0,
                  mark_expanded: Optional[np.ndarray] = None,
                  task_ids: Optional[np.ndarray] = None,
                  worker_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Insert ``n`` tasks; ``duration_est`` may be a scalar or per-task
        array. ``mark_expanded`` flips the ``expanded`` flag of the given
        parent rows in the SAME transaction / log record, so dependency
        expansion (children inserted + parents marked) is atomic: a replica
        can never observe the children without the dedup mark.

        ``task_ids`` overrides the queue-local id counter so an external
        router (e.g. ``ShardRouter``) can keep ids globally unique across
        shards — cross-shard work stealing re-inserts tasks under their
        original ids. ``worker_ids`` overrides the default round-robin
        partition assignment (values must lie in ``[0, num_workers)``)."""
        if task_ids is not None:
            ids = np.asarray(task_ids, np.int64)
            if len(ids) != n:
                raise ValueError(f"task_ids has {len(ids)} entries, n={n}")
            if n:
                self._next_task_id = max(self._next_task_id,
                                         int(ids.max()) + 1)
        else:
            ids = np.arange(self._next_task_id, self._next_task_id + n,
                            dtype=np.int64)
            self._next_task_id += n
        dur = np.asarray(duration_est, np.float64)
        rows = {
            "task_id": ids,
            "activity_id": np.full(n, activity_id, np.int32),
            "worker_id": (np.asarray(worker_ids, np.int32)
                          if worker_ids is not None
                          else assign_workers(ids, self.num_workers)),
            "status": np.full(n, int(status), np.int32),
            "submit_time": np.full(n, now, np.float64),
            "duration_est": (np.full(n, float(dur)) if dur.ndim == 0
                             else dur.astype(np.float64, copy=False)),
        }
        if domain_in is not None:
            for i in range(domain_in.shape[1]):
                rows[f"in{i}"] = domain_in[:, i]
        if parent_task is not None:
            rows["parent_task"] = parent_task
        with self.store.txn():
            idx = self.store.insert(rows)
            if mark_expanded is not None and len(mark_expanded):
                self.store.update(np.asarray(mark_expanded), expanded=1)
            payload = {"activity_id": activity_id, "n": n, "ids": ids,
                       "rows": rows, "row_idx": idx}
            if mark_expanded is not None and len(mark_expanded):
                payload["expanded_rows"] = np.asarray(mark_expanded)
            self._append_log("insert", payload)
            if status == Status.READY:
                self._ready_delta(rows["worker_id"], +1)
        return ids

    # ---------------------------------------------------------------- claim
    def claim(self, worker_id: int, k: int = 1, *,
              now: float = 0.0, allow_steal: bool = False) -> np.ndarray:
        """getREADYtasks + updateToRUNNING for one worker (partition-private).

        Returns claimed row indices (== task ids here). Scans the partition's
        ready suffix (``_cursor``) in geometrically growing blocks, stopping
        as soon as k matches are found — O(k·W)-ish for round-robin
        partitions instead of O(store).
        """
        with self.store.txn():
            n = self.store.n_rows
            start = int(self._cursor[worker_id])
            status = self.store.col("status")
            wid = self.store.col("worker_id")
            found: List[np.ndarray] = []
            n_found = 0
            pos = start
            block = max(1024, 16 * k * self.num_workers)
            while pos < n and n_found <= k:      # one extra match tells us
                end = min(n, pos + block)        # the partition isn't drained
                m = (status[pos:end] == int(Status.READY)) \
                    & (wid[pos:end] == worker_id)
                rel = np.nonzero(m)[0]
                if len(rel):
                    found.append(rel + pos)
                    n_found += len(rel)
                pos = end
                block *= 2
            rel_all = np.concatenate(found) if found \
                else np.empty(0, np.int64)
            idx = rel_all[:k]
            if n_found <= k and pos >= n:        # partition drained
                self._cursor[worker_id] = n
            elif len(idx):
                self._cursor[worker_id] = int(idx[-1]) + 1
            if len(idx) == 0 and allow_steal:
                idx = self._steal(worker_id, k)
            if len(idx):
                # decrement against the partitions the rows LEAVE (stolen
                # rows leave the victim's count) before wid is overwritten
                self._ready_delta(wid[idx], -1)
                self.store.update(idx, status=int(Status.RUNNING),
                                  start_time=now, worker_id=worker_id,
                                  core_id=worker_id, claimed_at=now,
                                  heartbeat_at=now,
                                  expires_at=now + self.store.lease_s)
                self._append_log("claim", {
                    "worker": worker_id, "rows": idx, "now": now,
                    "ids": self.store.col("task_id")[idx]})
        return idx

    def _steal(self, thief: int, k: int) -> np.ndarray:
        """Claim from the most-loaded sibling partition.

        Victim pick is O(W) off the incrementally maintained ready counts —
        no suffix scan, no bincount over READY rows. Only the VICTIM's
        cursor suffix is then scanned to materialize its first k rows.
        No [0, W) cap on the victim id: a partition orphaned by a
        shrink-resize is a valid victim (counts extend past num_workers),
        same as the seed loop — otherwise claim()-driven schedulers could
        never rescue those rows.
        """
        if not self._ready.size:
            return np.empty(0, np.int64)
        victim = int(np.argmax(self._ready))
        if self._ready[victim] == 0 or victim == thief:
            return np.empty(0, np.int64)
        n = self.store.n_rows
        start = int(self._cursor[victim]) if victim < self.num_workers \
            else min(int(self._orphan_lo), n)
        status = self.store.col("status")
        wid = self.store.col("worker_id")
        idx = np.nonzero((status[start:] == int(Status.READY))
                         & (wid[start:] == victim))[0][:k] + start
        return idx

    def claim_all(self, k: int = 1, *, now: float = 0.0,
                  steal: bool = True) -> Dict[int, np.ndarray]:
        """Batched claim: next k READY tasks for EVERY worker in one pass.

        This is the SPMD form the executor uses (and the semantics of the
        wq_claim kernel). Vectorized end to end: stable worker-sort of the
        ready rows gives per-worker segments, bincount offsets give in-segment
        ranks (rank < k == claimed), and stealing redistributes the unclaimed
        pool onto deficit workers with one repeat/argsort/split round.
        Observationally equivalent to :meth:`claim_all_reference`.
        """
        W = self.num_workers
        if k < 1:
            return {w: np.empty(0, np.int64) for w in range(W)}
        with self.store.txn():
            n = self.store.n_rows
            start = self.scan_start()
            if self.device_claim:
                claimed, n_claimed, pool = self._primary_device(start, k)
            else:
                claimed, n_claimed, pool = self._primary_host(start, k)

            # advance cursors: a worker that claimed < k drained its
            # partition; one that claimed exactly k stops right after its
            # k-th claimed row (earlier READY rows are all claimed)
            offs_c = np.cumsum(n_claimed) - n_claimed
            new_cur = np.full(W, n, np.int64)
            full = n_claimed >= k
            if full.any():
                new_cur[full] = claimed[offs_c[full] + k - 1] + 1
            self._cursor = np.maximum(self._cursor, new_cur)

            # stealing as ONE vectorized redistribution: deficit workers
            # (ascending id, reference semantics) receive the leftover pool
            # (ascending row order) in contiguous chunks
            extras = np.empty(0, np.int64)
            recipients = np.empty(0, np.int64)
            if steal and pool.size:
                need = k - n_claimed
                if need.sum() > 0:
                    recipients = np.repeat(np.arange(W), need)[: pool.size]
                    extras = pool[: recipients.size]

            rows_all = np.concatenate([claimed, extras])
            w_all = np.concatenate(
                [np.repeat(np.arange(W), n_claimed), recipients])
            redo = np.argsort(w_all, kind="stable")   # per worker: primary
            rows_all = rows_all[redo]                 # rows, then stolen rows
            tot = n_claimed + np.bincount(recipients, minlength=W)
            out = dict(enumerate(np.split(rows_all, np.cumsum(tot)[:-1])))

            if len(rows_all):
                # claim_all never reassigns worker_id: decrement the counts
                # of the partitions the rows leave (stolen rows included)
                self._ready_delta(self.store.col("worker_id")[rows_all], -1)
                # lease stamps ride the SAME transaction / log record as the
                # RUNNING flip: the hot wire frame still carries only
                # rows/now — both sides derive expires_at = now + lease_s
                self.store.update(rows_all, status=int(Status.RUNNING),
                                  start_time=now, claimed_at=now,
                                  heartbeat_at=now,
                                  expires_at=now + self.store.lease_s)
                self._append_log("claim_all", {"n": len(rows_all),
                                               "rows": rows_all, "now": now})
        return out

    def _primary_host(self, start: int, k: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized primary claim phase over the ready suffix.

        Scans in geometrically growing blocks and stops as soon as every
        worker's budget is met — for dense round-robin partitions that is
        one small block, independent of store size. Per block, k == 1 uses
        a stable worker-sort + bincount segment offsets for in-partition
        ranks (rank below the remaining quota == claimed); k > 1 uses a
        SEGMENTED ARGPARTITION over the exact per-partition ready counts
        (:meth:`_block_take_argpartition`) — selection instead of a full
        sort of the block's ready rows. The leftover pool for stealing is
        only materialized when quotas stay unmet after a full scan (and the
        suffix is cheap to rescan exactly then).

        Returns (claimed rows in worker-major order, per-worker claim counts,
        leftover READY rows in ascending row order).
        """
        W = self.num_workers
        n = self.store.n_rows
        status = self.store.col("status")
        wid = self.store.col("worker_id")
        # quota capped by the maintained per-partition READY counts: a
        # partition can never yield more than it has, so capping changes
        # nothing about what gets claimed — but the scan loop now stops as
        # soon as every AVAILABLE row is found instead of walking the whole
        # suffix hunting for rows that do not exist (heavy-tail k>1 claims
        # on dried-up partitions used to pay a full O(store) rescan here)
        total_ready = int(self._ready.sum()) + self._ready_neg
        need = np.minimum(np.full(W, k, np.int64), self.ready_counts())
        take_block = self._block_take_sort if k == 1 \
            else self._block_take_argpartition
        parts: List[np.ndarray] = []
        pos = start
        # k > 1 right-sizes the first block to the QUOTA the ready counts
        # prove is claimable (~2 rows scanned per claim on a round-robin
        # suffix) instead of 16x it — selection cost tracks what gets
        # claimed, and geometric growth still covers skewed layouts
        block = max(4096, 16 * k * W) if k == 1 else max(1024, 2 * k * W)
        while pos < n and need.any():
            end = min(n, pos + block)
            rr = np.nonzero(status[pos:end] == int(Status.READY))[0] + pos
            if rr.size:
                got, counts = take_block(rr, wid[rr], need)
                parts.append(got)
                need -= np.minimum(counts, need)
            pos = end
            block *= 2
        rows = np.concatenate(parts) if parts else np.empty(0, np.int64)
        if k == 1:
            # blocks are ascending and the sort path keeps row order within
            # each partition: stable sort by worker suffices
            order = np.argsort(wid[rows], kind="stable")
        else:
            # argpartition leaves rows unordered within a partition: lexsort
            # the <= k*W claimed rows back to (worker-major, row-ascending),
            # the reference order the cursor advance and callers rely on
            order = np.lexsort((rows, wid[rows]))
        claimed = rows[order]                          # sorted within worker
        n_claimed = np.bincount(wid[rows], minlength=W)
        if (n_claimed < k).any() and total_ready > len(rows):
            # deficits remain AND unclaimed READY rows exist (beyond-quota
            # rows of loaded partitions, or orphaned partitions): only then
            # is the steal pool materialized, via one suffix scan — when the
            # counts show nothing is left the scan is skipped entirely
            left = np.zeros(n - start, bool)
            left[np.nonzero(status[start:] == int(Status.READY))[0]] = True
            left[rows - start] = False
            pool = np.nonzero(left)[0] + start
            self._advance_orphan_watermark(pool, wid)
        else:
            pool = np.empty(0, np.int64)
        return claimed, n_claimed, pool

    def _block_take_sort(self, rr: np.ndarray, rw: np.ndarray,
                         need: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """k == 1 block selection: stable worker-sort + bincount ranks.

        Returns (claimed rows of this block — row-ascending within each
        partition, in-range partition counts). One stable sort groups the
        partitions while keeping row order, so in-segment position IS the
        rank; partition ids outside [0, W) are dropped by the searchsorted
        bounds (they belong to the steal pool).
        """
        W = self.num_workers
        order = np.argsort(rw, kind="stable")      # groups workers,
        srows = rr[order]                          # keeps row order
        sw = rw[order]                             # within each
        lo = int(np.searchsorted(sw, 0))           # partition ids
        hi = int(np.searchsorted(sw, W))           # outside [0, W)
        seg_rows, seg_w = srows[lo:hi], sw[lo:hi]
        counts = np.bincount(seg_w, minlength=W)
        offs = np.cumsum(counts) - counts
        rank = np.arange(len(seg_rows)) - np.repeat(offs, counts)
        return seg_rows[rank < need[seg_w]], counts

    def _block_take_argpartition(self, rr: np.ndarray, rw: np.ndarray,
                                 need: np.ndarray
                                 ) -> Tuple[np.ndarray, np.ndarray]:
        """k > 1 block selection: segmented argpartition, no full sort.

        Composite key (partition-major, row-minor) makes the global sorted
        order partition-contiguous; one multi-kth ``np.argpartition`` with a
        pin at every partition's END (so segments cannot bleed into each
        other) plus a pin at every partition's QUOTA CUT (exact ready
        counts bound the cut) places each partition's ``need[w]``
        lowest-index ready rows — the exact rows the reference loop claims —
        in its quota window, in O(R) selection passes instead of the
        O(R log R) stable sort the k == 1 path pays. The claimed rows come
        back UNORDERED within each partition; the caller re-orders the
        (small) claimed set, never the block.
        """
        W = self.num_workers
        ok = (rw >= 0) & (rw < W)              # out-of-range ids: steal pool
        rr_in = rr[ok]
        rw_in = rw[ok].astype(np.int64, copy=False)
        counts = np.bincount(rw_in, minlength=W)
        take = np.minimum(counts, need)
        tot = int(take.sum())
        if not tot:
            return np.empty(0, np.int64), counts
        key = rw_in * np.int64(self.store.n_rows + 1) + rr_in
        ends = np.cumsum(counts)
        offs = ends - counts
        kth = np.unique(np.concatenate(
            [ends[counts > 0] - 1, (offs + take - 1)[take > 0]]))
        part = np.argpartition(key, kth)
        seg = np.repeat(np.arange(W), take)    # quota-window positions:
        within = np.arange(tot) \
            - np.repeat(np.cumsum(take) - take, take)
        return rr_in[part[offs[seg] + within]], counts

    def _advance_orphan_watermark(self, pool: np.ndarray,
                                  wid: np.ndarray) -> None:
        """Given the COMPLETE set of unclaimed READY rows, re-derive the
        orphan watermark exactly (lazy advance — it only ever lowers on
        fail-retry, so this is where it recovers)."""
        pw = wid[pool]
        orph = pool[(pw < 0) | (pw >= self.num_workers)]
        self._orphan_lo = int(orph.min()) if orph.size else self._NO_ORPHANS

    def _primary_device(self, start: int, k: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Primary claim phase on ``self.device`` via the wq_claim op.

        The kernel computes the per-worker rank<k claim mask in one
        data-parallel pass; the host applies the resulting mask to the
        authoritative store (stealing stays host-side).
        """
        from repro_torch.device import resolve_device
        from repro_torch.kernels.wq_claim.ops import wq_claim_columns
        status = self.store.col("status")[start:]
        wid_full = self.store.col("worker_id")
        claim_mask, new_status = wq_claim_columns(
            status, wid_full[start:], num_workers=self.num_workers, k=k,
            device=resolve_device(self.device))
        rows = np.nonzero(claim_mask)[0] + start
        # the op gives rank 0 to rows whose partition id is outside [0, W)
        # (the reference oracle's semantics), so it "claims" them
        # regardless of budget — route those to the steal pool instead,
        # matching the host path's searchsorted lo/hi split
        w_rows = wid_full[rows]
        ok = (w_rows >= 0) & (w_rows < self.num_workers)
        orphans = rows[~ok]
        rows, w_rows = rows[ok], w_rows[ok]
        order = np.argsort(w_rows, kind="stable")
        claimed = rows[order]
        n_claimed = np.bincount(w_rows, minlength=self.num_workers)
        pool = np.sort(np.concatenate(
            [np.nonzero(new_status == int(Status.READY))[0] + start,
             orphans]))
        self._advance_orphan_watermark(pool, wid_full)
        return claimed, n_claimed, pool

    def claim_all_reference(self, k: int = 1, *, now: float = 0.0,
                            steal: bool = True) -> Dict[int, np.ndarray]:
        """The seed O(n·W) loop implementation, kept verbatim as the oracle
        for equivalence tests and the claim-path speedup benchmark."""
        status = self.store.col("status")
        wid = self.store.col("worker_id")
        ready = status == int(Status.READY)
        out: Dict[int, np.ndarray] = {}
        claimed_rows: List[np.ndarray] = []
        for w in range(self.num_workers):
            idx = np.nonzero(ready & (wid == w))[0][:k]
            out[w] = idx
            claimed_rows.append(idx)
        if steal:
            leftovers = np.nonzero(ready)[0]
            taken = set(np.concatenate(claimed_rows).tolist())
            pool = [i for i in leftovers if i not in taken]
            for w in range(self.num_workers):
                need = k - len(out[w])
                if need > 0 and pool:
                    extra = np.asarray(pool[:need], dtype=np.int64)
                    pool = pool[need:]
                    out[w] = np.concatenate([out[w], extra])
                    claimed_rows.append(extra)
        all_idx = np.concatenate([v for v in out.values() if len(v)]) \
            if any(len(v) for v in out.values()) else np.empty(0, np.int64)
        if len(all_idx):
            self.store.update(all_idx, status=int(Status.RUNNING),
                              start_time=now, claimed_at=now,
                              heartbeat_at=now,
                              expires_at=now + self.store.lease_s)
            self._append_log("claim_all", {"n": len(all_idx),
                                           "rows": all_idx, "now": now})
        self.invalidate_cursors()      # bypasses the cursor bookkeeping
        return out

    # ------------------------------------------------------------- complete
    def finish(self, idx: np.ndarray, *, now: float = 0.0,
               domain_out: Optional[np.ndarray] = None) -> None:
        self._check_transition(idx, Status.FINISHED)
        with self.store.txn():
            # finishing IS the lease renewal for the terminal hop: a worker
            # that reports a result proves liveness at `now`
            upd = {"status": int(Status.FINISHED), "end_time": now,
                   "heartbeat_at": now}
            self.store.update(np.asarray(idx), **upd)
            payload = {"ids": np.asarray(idx), "rows": np.asarray(idx),
                       "now": now}
            if domain_out is not None:
                cols = {f"out{i}": domain_out[:, i]
                        for i in range(domain_out.shape[1])}
                self.store.update(np.asarray(idx), **cols)
                payload["domain_out"] = np.asarray(domain_out)
            self._append_log("finish", payload)

    def fail(self, idx: np.ndarray, *, now: float = 0.0,
             max_trials: int = 3) -> None:
        """Failure handling: retry (back to READY) until fail_trials exhausts."""
        idx = np.asarray(idx)
        with self.store.txn():
            trials = self.store.col("fail_trials")[idx] + 1
            retry = idx[trials < max_trials]
            dead = idx[trials >= max_trials]
            self.store.update(idx, fail_trials=trials)
            if len(retry):
                self.store.update(retry, status=int(Status.READY))
                self._lower_cursors(retry, self.store.col("worker_id")[retry])
                self._ready_delta(self.store.col("worker_id")[retry], +1)
            if len(dead):
                self.store.update(dead, status=int(Status.FAILED),
                                  end_time=now)
            self._append_log("fail", {"retry": retry, "dead": dead,
                                      "rows": idx, "trials": trials,
                                      "now": now})

    def requeue_worker(self, worker_id: int, *, reassign: bool = True) -> int:
        """Node failure: return the dead worker's RUNNING tasks to READY and
        (optionally) rehash them to live partitions."""
        with self.store.txn():
            idx = self.store.where(worker_id=worker_id,
                                   status=int(Status.RUNNING))
            if len(idx) == 0:
                return 0
            self.store.update(idx, status=int(Status.READY))
            trials = self.store.col("fail_trials")[idx] + 1
            self.store.update(idx, fail_trials=trials)
            if reassign and self.num_workers > 1:
                live = [w for w in range(self.num_workers) if w != worker_id]
                new_w = np.asarray(live, np.int32)[
                    self.store.col("task_id")[idx] % len(live)]
                self.store.update(idx, worker_id=new_w)
            self._lower_cursors(idx, self.store.col("worker_id")[idx])
            self._ready_delta(self.store.col("worker_id")[idx], +1)
            self._append_log("requeue_worker", {
                "worker": worker_id, "n": len(idx), "rows": idx,
                "trials": trials,
                "new_worker": self.store.col("worker_id")[idx]})
            return len(idx)

    # --------------------------------------------------------------- leases
    def reap_expired(self, *, now: float = 0.0, max_trials: int = 3) -> int:
        """Vectorized stale-claim reaper (Work Claim Pattern).

        Requeues every RUNNING row whose lease deadline has passed in ONE
        masked transition: fail_trials bumps, rows below ``max_trials`` go
        back to READY (lease columns cleared so the row is visibly
        unleased), exhausted rows go to FAILED — both legs checked against
        the legality matrix. Worker death thus becomes a data-plane event:
        no supervisor round-trip, and the record replays on replicas and
        per-shard stores through the ordinary cold log path. NaN
        ``expires_at`` (no lease taken) never matches the mask, so rows
        claimed by legacy paths are left alone.

        Requeued rows are rehashed onto the CURRENT partition map
        (``assign_workers`` at today's ``num_workers``): the dead worker's
        partition may no longer exist after a :meth:`resize`, and a stale
        ``worker_id`` would strand the row outside every live scan range.
        The assignment rides the log record (``new_worker``) so replicas
        land the rows identically. Returns rows reaped.
        """
        with self.store.txn():
            st = self.store.col("status")
            exp = self.store.col("expires_at")
            mask = (st == int(Status.RUNNING)) & (exp < now)
            idx = np.nonzero(mask)[0]
            if not len(idx):
                return 0
            trials = self.store.col("fail_trials")[idx] + 1
            retry = idx[trials < max_trials]
            dead = idx[trials >= max_trials]
            self._check_transition(retry, Status.READY)
            self._check_transition(dead, Status.FAILED)
            self.store.update(idx, fail_trials=trials)
            new_worker = None
            if len(retry):
                new_worker = assign_workers(
                    self.store.col("task_id")[retry], self.num_workers)
                self.store.update(retry, status=int(Status.READY),
                                  claimed_at=np.nan, heartbeat_at=np.nan,
                                  expires_at=np.nan, worker_id=new_worker)
                self._lower_cursors(retry, new_worker)
                self._ready_delta(new_worker, +1)
            if len(dead):
                self.store.update(dead, status=int(Status.FAILED),
                                  end_time=now)
            self._append_log("reap", {"rows": idx, "retry": retry,
                                      "dead": dead, "trials": trials,
                                      "new_worker": new_worker,
                                      "now": now})
            return len(idx)

    def renew_leases(self, idx: np.ndarray, *, now: float = 0.0) -> int:
        """Heartbeat: push the lease deadline of still-RUNNING rows to
        ``now + lease_s``. Rows that already left RUNNING (finished, reaped)
        are skipped — a late heartbeat cannot resurrect a reaped claim.
        Returns the number of leases renewed."""
        idx = np.asarray(idx, np.int64)
        with self.store.txn():
            if len(idx):
                st = self.store.col("status")[idx]
                idx = idx[st == int(Status.RUNNING)]
            if not len(idx):
                return 0
            self.store.update(idx, heartbeat_at=now,
                              expires_at=now + self.store.lease_s)
            self._append_log("lease_renew", {"rows": idx, "now": now})
            return len(idx)

    def autoscale_signals(self, *, now: float = 0.0) -> Dict[str, float]:
        """HPA-style signals derived from the relation itself: pending
        (READY+BLOCKED) count, oldest-pending backlog age, p95
        submit-to-claim latency over claimed rows, and the RUNNING count.
        This is what ``ElasticController`` scales the pool from."""
        st = self.store.col("status")
        pending = (st == int(Status.READY)) | (st == int(Status.BLOCKED))
        n_pending = int(pending.sum())
        backlog_age = 0.0
        if n_pending:
            oldest = np.nanmin(self.store.col("submit_time")[pending])
            if not np.isnan(oldest):
                backlog_age = max(0.0, float(now) - float(oldest))
        lat = (self.store.col("claimed_at")
               - self.store.col("submit_time"))
        lat = lat[~np.isnan(lat)]
        p95 = max(0.0, float(np.percentile(lat, 95))) if lat.size else 0.0
        return {"pending": float(n_pending),
                "backlog_age_s": backlog_age,
                "claim_p95_s": p95,
                "running": float((st == int(Status.RUNNING)).sum())}

    # ------------------------------------------------------------- steering
    def prune(self, rows: np.ndarray) -> int:
        """Steering's data reduction: mark the given READY/BLOCKED rows
        PRUNED, with txn logging and ready-count maintenance. Lives here —
        not in the steering engine — so every status write that touches the
        incremental ready counts stays inside the WorkQueue."""
        rows = np.asarray(rows)
        if not len(rows):
            return 0
        with self.store.txn():
            st = self.store.col("status")[rows]
            was_ready = rows[st == int(Status.READY)]
            if len(was_ready):
                self._ready_delta(self.store.col("worker_id")[was_ready], -1)
            self.store.update(rows, status=int(Status.PRUNED))
            self._append_log("steer_prune", {"n": len(rows), "rows": rows})
        return len(rows)

    # --------------------------------------------------------------- elastic
    def resize(self, new_workers: int) -> int:
        """Elastic scaling: re-hash non-terminal tasks to W' partitions."""
        with self.store.txn():
            status = self.store.col("status")
            movable = np.isin(status, [int(Status.READY),
                                       int(Status.BLOCKED)])
            idx = np.nonzero(movable)[0]
            tids = self.store.col("task_id")[idx]
            new_assign = assign_workers(tids, new_workers)
            moved = int(np.sum(new_assign !=
                               self.store.col("worker_id")[idx]))
            self.store.update(idx, worker_id=new_assign)
            self.num_workers = new_workers
            self._cursor = np.zeros(new_workers, np.int64)
            # re-hash reassigned every READY/BLOCKED row into [0, W'), so no
            # READY orphan can exist right after a resize
            self._orphan_lo = self._NO_ORPHANS
            self._recount_ready()        # same READY set, new partition keys
            self._append_log("resize", {"workers": new_workers,
                                        "moved": moved, "rows": idx,
                                        "assign": new_assign})
            return moved

    # ------------------------------------------------------------ invariants
    def _check_transition(self, idx: np.ndarray, to: Status) -> None:
        """Vectorized legality check: one gather into the precomputed
        boolean matrix (schema.LEGAL_TRANSITIONS) indexed by
        (current_status, to) — no per-distinct-status Python loop."""
        cur = self.store.col("status")[np.asarray(idx)]
        bad = ~LEGAL_TRANSITIONS[cur, int(to)]
        if bad.any():
            c = int(cur[np.argmax(bad)])
            raise ValueError(
                f"illegal transition {Status(c).name} -> {to.name}")

    def check_invariants(self) -> None:
        """Property-test hooks: every task in exactly one status; RUNNING
        tasks have start_time; FINISHED have end >= start; partition ids in
        range; no READY row hides below its partition's ready cursor."""
        st = self.store.col("status")
        assert ((st >= int(Status.EMPTY)) & (st <= int(Status.PRUNED))).all()
        wid = self.store.col("worker_id")
        used = st != int(Status.EMPTY)
        assert (wid[used] >= 0).all() and (wid[used] < self.num_workers).all()
        running = st == int(Status.RUNNING)
        assert not np.isnan(self.store.col("start_time")[running]).any()
        fin = st == int(Status.FINISHED)
        ok = (self.store.col("end_time")[fin]
              >= self.store.col("start_time")[fin])
        assert ok.all()
        ready_rows = np.nonzero(st == int(Status.READY))[0]
        rw = wid[ready_rows]
        in_range = (rw >= 0) & (rw < self.num_workers)
        assert not (ready_rows[in_range]
                    < self._cursor[rw[in_range]]).any()
        # incremental ready counts must equal a fresh recount, exactly
        want = np.bincount(rw[rw >= 0].astype(np.int64),
                           minlength=self._ready.size) if rw.size \
            else np.zeros(self._ready.size, np.int64)
        if want.size < self._ready.size:
            want = np.concatenate(
                [want, np.zeros(self._ready.size - want.size, np.int64)])
        assert np.array_equal(self._ready, want), (self._ready, want)
        assert self._ready_neg == int((rw < 0).sum())

    # ------------------------------------------------------------- counters
    def counts(self) -> Dict[str, int]:
        stats = self.store.stats()           # one bincount (_status_stats)
        return {s.name: stats[int(s)] for s in Status}
