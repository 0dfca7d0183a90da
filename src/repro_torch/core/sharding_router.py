"""ShardRouter: N full primaries behind one routing facade (paper §4-5).

SchalaDB's scalability argument rests on PARTITIONED OWNERSHIP: the Task
table is hash-distributed across data nodes, every node is a primary for
its partitions, and the execution engine + steering queries operate on the
union. Our single ``WorkQueue`` reproduces the node-local engine; this
module reproduces the distribution layer:

* **hash routing** — task id -> shard via the same modulo family the
  WorkQueue already uses for partitions. With ``W = S * L`` global workers
  (S shards x L local partitions), shard ``(tid % W) // L`` and local
  partition ``tid % L`` compose to the exact global partition ``tid % W``
  a single W-worker primary would assign, which is what makes the
  single-primary oracle comparisons in ``benchmarks/simkit.run_sharded``
  exact rather than statistical.
* **full primaries** — each shard owns a private ``ColumnStore`` +
  ``TxnLog`` and (optionally) a replicator from the existing
  :func:`~repro_torch.core.replication.make_replicator` factory, so compaction,
  wire shipping, and fan-out all work per shard unchanged.
* **scatter-gather steering** — :meth:`run_all` pins one snapshot per
  shard (a *version vector*), computes per-shard partial aggregates with
  the same bincount/segment reductions as
  :class:`~repro_torch.core.steering.SteeringEngine`, and merges them into
  results bit-identical to a single primary at the same data (Q7's
  provenance walk crosses shards through an id -> (shard, row) map).
* **cross-shard work stealing** — when a shard's incremental READY counts
  drain, :meth:`rebalance` pulls a batch from the richest sibling over a
  real ``Transport`` endpoint pair; the victim logs a prune and the thief
  logs a NORMAL insert (original task ids preserved), so each shard's
  replicas replay to bit-parity without any new log record type. The
  hand-off is two-phase: the victim's prune is PROVISIONAL until the
  thief's insert acks, and a transport death mid-steal rolls the chunk
  back as a logged re-insert — no task is ever lost to a dead wire.
* **shard-primary failover** — :meth:`fail_shard` marks a primary dead
  (it stops serving claims/inserts/steals; the other shards keep
  claiming), and :meth:`promote_shard` elects its most-caught-up replica
  via the existing ``Replicator.promote()``, drains the surviving log
  tail, requeues RUNNING rows, rebuilds the shard's WorkQueue around the
  promoted store, re-registers a fresh replicator, and re-arms the
  per-shard supervision (:meth:`attach_supervision`) with a bumped
  generation — not one committed transaction on any shard is lost.

Float caveat for bit-parity: merged Q6/Q7 means add per-shard partial sums
in shard order while the oracle sums in row order. For workloads whose
times are exactly representable (the drills use dyadic clocks) the results
are bit-identical; for arbitrary floats they agree to ulp-level
reassociation error.
"""
from __future__ import annotations

import concurrent.futures
import pickle
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.schema import Status
from repro_torch.core.steering import Q7_ACT_A, sweep_partials
from repro_torch.core.store import SnapshotView
from repro_torch.core.transport import TCPTransport
from repro_torch.core.workqueue import WorkQueue

_OPEN = (int(Status.READY), int(Status.RUNNING), int(Status.BLOCKED))

# steal batches cross the wire in bounded frames with a strict
# send -> recv alternation, so an in-process endpoint pair (socketpair)
# can never deadlock on a kernel buffer, whatever the batch size
_STEAL_CHUNK_ROWS = 256


class UnrecoverableShardError(RuntimeError):
    """A failed shard primary cannot be promoted: it has no replicator, or
    every replica in its group is dead too. The shard's committed state is
    only reachable through a durable checkpoint at this point."""


class DeadShardError(RuntimeError):
    """A remote sweep targeted a failed shard primary. A merged Q1-Q7
    result that silently excluded a shard would misreport global state, so
    the scatter refuses instead: ``promote_shard`` the dead primary first,
    or run :meth:`ShardRouter.run_all` over explicitly pinned snapshots of
    the frozen stores."""


def merge_partials(partials: Iterable[Dict[str, object]]
                   ) -> Dict[str, object]:
    """Combine per-shard :func:`~repro_torch.core.steering.sweep_partials` into
    the single-primary Q1-Q7 result shape — the pure merge half of the
    distributed sweep.

    Shard index is list position; worker slabs land in disjoint global
    slots (``lo = sum of preceding shards' n_workers``), Q5/Q6 segment
    partials add in shard order (bit-stable for dyadic times), Q6 maxima
    combine by elementwise max, and Q7 filters each shard's candidate
    hits against the GLOBAL duration mean before the cross-shard parent
    walk. ``q7`` holds sorted global task ids and ``version`` the version
    vector, exactly as :meth:`ShardRouter.run_all` documents.
    """
    partials = list(partials)
    if not partials:
        raise ValueError("merge_partials needs at least one partial")
    sizes = [int(p["n_workers"]) for p in partials]
    W = sum(sizes)
    started = np.zeros(W, np.int64)
    finished = np.zeros(W, np.int64)
    failures = np.zeros(W, np.int64)
    fail_counts = np.zeros(W, np.int64)
    q4 = 0
    q5_counts = np.zeros(1, np.int64)
    q6_cnt = np.zeros(1, np.int64)
    q6_sum = np.zeros(1, np.float64)
    q6_max = np.full(1, -np.inf)
    q6_open: set = set()
    q7_sum, q7_cnt, q7_any = 0.0, 0, False

    def grow(arr, n, fill=0):
        if n <= arr.size:
            return arr
        out = np.full(n, fill, arr.dtype)
        out[:arr.size] = arr
        return out

    lo = 0
    for p, L in zip(partials, sizes):
        started[lo:lo + L] += p["started"]
        finished[lo:lo + L] += p["finished"]
        failures[lo:lo + L] += p["failures"]
        fail_counts[lo:lo + L] += p["fail_counts"]
        lo += L
        q4 += int(p["q4"])
        bc = p["q5_counts"]
        if bc.size:
            q5_counts = grow(q5_counts, bc.size)
            q5_counts[:bc.size] += bc
        q6_open.update(np.asarray(p["q6_open"]).tolist())
        n_act = p["q6_cnt"].size
        if n_act:
            q6_cnt = grow(q6_cnt, n_act)
            q6_sum = grow(q6_sum, n_act)
            q6_max = grow(q6_max, n_act, -np.inf)
            q6_cnt[:n_act] += p["q6_cnt"]
            q6_sum[:n_act] += p["q6_sum"]
            q6_max[:n_act] = np.maximum(q6_max[:n_act], p["q6_max"])
        if p["q7_any"]:
            q7_any = True
            q7_sum += float(p["q7_sum"])
            q7_cnt += int(p["q7_cnt"])

    q1 = {int(w): {"started": int(started[w]),
                   "finished": int(finished[w]),
                   "failures": int(failures[w])}
          for w in np.nonzero(started)[0]}
    q3 = (np.nonzero(fail_counts == fail_counts.max())[0].tolist()
          if fail_counts.any() else [])
    q5 = ((int(np.argmax(q5_counts)), int(q5_counts.max()))
          if q5_counts.any() else (-1, 0))
    q6 = {}
    if q6_cnt.any() and q6_open:
        for a in np.nonzero(q6_cnt)[0]:
            if int(a) in q6_open:
                q6[int(a)] = (float(q6_sum[a] / q6_cnt[a]),
                              float(q6_max[a]))
        q6 = dict(sorted(q6.items(), key=lambda kv: -kv[1][0]))
    q7 = _merge_q7(partials, q7_any, q7_sum, q7_cnt)
    return {"q1": q1, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q7": q7,
            "version": [int(p["version"]) for p in partials]}


def _merge_q7(partials: Sequence[Dict[str, object]], any_fin_b: bool,
              dsum: float, dcnt: int) -> List[int]:
    """Cross-shard provenance walk over the partials' compact ancestry
    arrays: per-shard candidate hits filtered against the GLOBAL mean,
    then parent edges chased through an id -> (shard, compact row) map
    (live copies shadow PRUNED tombstones). Returns sorted task ids —
    the multiset a single primary's row-index result maps to."""
    if not any_fin_b or dcnt == 0:
        return []
    mean = dsum / dcnt
    max_id = -1
    for p in partials:
        if p["anc_ids"].size:
            max_id = max(max_id, int(p["anc_ids"].max()))
    if max_id < 0:
        return []
    shard_of = np.full(max_id + 1, -1, np.int32)
    row_of = np.full(max_id + 1, -1, np.int64)
    for prefer_live in (False, True):       # live rows overwrite PRUNED
        for s, p in enumerate(partials):
            ids = p["anc_ids"]
            if prefer_live:
                keep = ~p["anc_pruned"]
                r = np.nonzero(keep)[0]
                ids = ids[keep]
            else:
                r = np.arange(ids.size, dtype=np.int64)
            shard_of[ids] = s
            row_of[ids] = r
    hits_s, hits_r = [], []
    for s, p in enumerate(partials):
        h = p["hit_idx"][p["hit_dur"] > mean]
        hits_s.append(np.full(len(h), s, np.int32))
        hits_r.append(h.astype(np.int64))
    cur_s = np.concatenate(hits_s)
    cur_r = np.concatenate(hits_r)
    if not len(cur_r):
        return []
    acts = [p["anc_act"] for p in partials]
    parents = [p["anc_parent"] for p in partials]
    while True:
        a = np.full(len(cur_r), -1, np.int64)
        pp = np.full(len(cur_r), -1, np.int64)
        for s in range(len(partials)):
            m = (cur_r >= 0) & (cur_s == s)
            if m.any():
                a[m] = acts[s][cur_r[m]]
                pp[m] = parents[s][cur_r[m]]
        walk = (cur_r >= 0) & (a > Q7_ACT_A) & (pp >= 0)
        if not walk.any():
            break
        pid = pp[walk]
        inb = pid <= max_id
        pid_c = np.minimum(pid, max_id)
        ns = np.where(inb, shard_of[pid_c], -1)
        nr = np.where(inb & (ns >= 0), row_of[pid_c], -1)
        cur_s[walk] = ns.astype(np.int32)
        cur_r[walk] = nr
    out = []
    for s, p in enumerate(partials):
        m = (cur_r >= 0) & (cur_s == s)
        if m.any():
            rows = cur_r[m]
            ok = acts[s][rows] == Q7_ACT_A
            out.append(p["anc_ids"][rows[ok]])
    if not out:
        return []
    return np.sort(np.concatenate(out)).tolist()


@dataclass
class Shard:
    """One primary: private queue (own store + txn log) + its replicator.

    ``alive`` is the serving flag — a dead shard keeps its (frozen) store
    and txn log in place as the WAL a promoted replica drains, but stops
    taking claims, inserts, reaps, and steals until :meth:`ShardRouter.
    promote_shard` swaps in the recovered WorkQueue. ``supervisor`` /
    ``secondary`` are the per-shard expansion pair installed by
    :meth:`ShardRouter.attach_supervision`; the secondary survives the
    primary's death and is promoted (generation bumped) with the shard.
    """
    index: int
    wq: WorkQueue
    replicator: Optional[object] = None
    steals_in: int = 0
    steals_out: int = 0
    alive: bool = True
    supervisor: Optional[object] = None
    secondary: Optional[object] = None


@dataclass
class StealStats:
    batches: int = 0
    tasks: int = 0
    wire_bytes: int = 0
    # two-phase hand-off: chunks whose transport died before the thief's
    # insert ack, rolled back on the victim as a logged re-insert
    rollbacks: int = 0
    rolled_back_tasks: int = 0
    per_shard_in: Dict[int, int] = field(default_factory=dict)


class ShardRouter:
    """Route a W-worker workload across ``num_shards`` full primaries.

    ``device`` is where every shard's queue runs its device claim (the
    ``wq_claim`` kernel on a CUDA device, its plain version on the CPU)
    when ``device_claim`` is on; ``claim_all`` claims the shards one after
    another on that device's one stream."""

    def __init__(self, num_shards: int, workers_per_shard: int, *,
                 capacity: int = 1 << 16,
                 replicate: Optional[str] = None,
                 replicas: int = 1,
                 sync_every: int = 64,
                 transport: Optional[str] = None,
                 device_claim: Optional[bool] = None,
                 lease_s: Optional[float] = None,
                 steal_recv_timeout: Optional[float] = 30.0,
                 device="cuda"):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if workers_per_shard < 1:
            raise ValueError("workers_per_shard must be >= 1")
        self.num_shards = num_shards
        self.workers_per_shard = workers_per_shard
        self.num_global_workers = num_shards * workers_per_shard
        self._next_task_id = 0
        # replication policy, kept so promote_shard / from_checkpoint can
        # re-arm a shard's replicator identically after a failover/restore
        self._capacity = capacity
        self._replicate = replicate
        self._replicas = replicas
        self._sync_every = sync_every
        self._transport = transport
        self._device_claim = device_claim
        self.device = device         # every shard queue's claim device
        self.shards: List[Shard] = []
        for s in range(num_shards):
            wq = WorkQueue(num_workers=workers_per_shard, capacity=capacity,
                           device_claim=device_claim, lease_s=lease_s,
                           device=device)
            rep = None
            if replicate is not None:
                from repro_torch.core.replication import make_replicator
                rep = make_replicator(wq, replicate, replicas=replicas,
                                      sync_every=sync_every,
                                      transport=transport,
                                      account_encoded=False)
            self.shards.append(Shard(index=s, wq=wq, replicator=rep))
        # the steal hop: one connected endpoint pair shared by all shards
        # (in-process stand-in for the victim->thief socket; the frames on
        # it are the real wire payloads). The recv deadline turns a wedged
        # sibling into a TransportError — which _pull's two-phase rollback
        # already handles — instead of a rebalance hung in recv forever.
        self._steal_tx, self._steal_rx = TCPTransport.pair(
            recv_timeout=steal_recv_timeout)
        self.steal_stats = StealStats()
        # persistent scatter pool: remote_sweep / sync_replicas /
        # replica_vector issue their per-shard requests concurrently, so
        # the analyst wall tracks max(shard), not the serial sum (the
        # ReplicaGroup fan-out pattern, one level up)
        self._scatter: Optional[concurrent.futures.ThreadPoolExecutor] = \
            concurrent.futures.ThreadPoolExecutor(
                max_workers=num_shards,
                thread_name_prefix="shard-scatter") \
            if num_shards > 1 else None
        self.last_scatter_wall_s: List[float] = [0.0] * num_shards
        self._closed = False

    # ------------------------------------------------------------- routing
    def shard_of(self, task_ids: np.ndarray) -> np.ndarray:
        """Owning shard per task id (hash routing)."""
        ids = np.asarray(task_ids, np.int64)
        return (ids % self.num_global_workers) // self.workers_per_shard

    def global_worker(self, shard: int, local_worker) -> np.ndarray:
        """Local partition id -> global worker id (the bijection that makes
        merged Q1/Q3 keys comparable with a single W-worker primary)."""
        return shard * self.workers_per_shard + np.asarray(local_worker)

    # ------------------------------------------------------------- inserts
    def add_tasks(self, activity_id: int, n: int, *,
                  status: Status = Status.READY,
                  duration_est=0.0,
                  domain_in: Optional[np.ndarray] = None,
                  parent_task: Optional[np.ndarray] = None,
                  now: float = 0.0) -> np.ndarray:
        """Insert ``n`` tasks with GLOBALLY unique ids, scattered to their
        owning shards (each shard insert is one normal logged txn)."""
        ids = np.arange(self._next_task_id, self._next_task_id + n,
                        dtype=np.int64)
        self._next_task_id += n
        dur = np.asarray(duration_est, np.float64)
        owner = self.shard_of(ids)
        for s, sh in enumerate(self.shards):
            m = owner == s
            cnt = int(m.sum())
            if not cnt:
                continue
            if not sh.alive:
                raise RuntimeError(
                    f"shard {s} is down (failed primary, not yet "
                    f"promoted) — cannot insert {cnt} tasks it owns")
            sh.wq.add_tasks(
                activity_id, cnt, status=status,
                duration_est=(float(dur) if dur.ndim == 0 else dur[m]),
                domain_in=None if domain_in is None else domain_in[m],
                parent_task=None if parent_task is None else
                np.asarray(parent_task)[m],
                now=now, task_ids=ids[m])
        return ids

    # -------------------------------------------------------------- claims
    def claim_all(self, k: int = 1, *, now: float = 0.0, steal: bool = True
                  ) -> Dict[int, Tuple[int, np.ndarray]]:
        """Batched claim on every shard: {global_worker: (shard, rows)}.

        ``rows`` index into that shard's store; ``steal`` here is the
        INTRA-shard redistribution the WorkQueue already does — cross-shard
        stealing is :meth:`rebalance`. Dead shards are skipped: the
        survivors' claim loops never stall on a failed sibling.
        """
        out: Dict[int, Tuple[int, np.ndarray]] = {}
        for s, sh in enumerate(self.shards):
            if not sh.alive:
                continue
            got = sh.wq.claim_all(k=k, now=now, steal=steal)
            for lw, rows in got.items():
                out[int(self.global_worker(s, lw))] = (s, rows)
        return out

    def ready_counts(self) -> np.ndarray:
        """Global READY-per-partition vector (length S*L): the concatenation
        of every shard's incremental counts."""
        return np.concatenate([sh.wq.ready_counts() for sh in self.shards])

    def tasks_left(self) -> int:
        """Q4 over the union of shards (the executor's termination check)."""
        return int(sum(
            np.isin(sh.wq.store.col("status"), _OPEN).sum()
            for sh in self.shards))

    def live_task_ids(self) -> np.ndarray:
        """Sorted ids of every materialized, non-PRUNED task across shards —
        the conservation invariant cross-shard stealing must preserve."""
        parts = []
        for sh in self.shards:
            st = sh.wq.store.col("status")
            keep = (st != int(Status.EMPTY)) & (st != int(Status.PRUNED))
            parts.append(sh.wq.store.col("task_id")[keep])
        return np.sort(np.concatenate(parts)) if parts \
            else np.empty(0, np.int64)

    # --------------------------------------------------------------- leases
    def reap_expired(self, *, now: float = 0.0, max_trials: int = 3) -> int:
        """Run the stale-claim reaper on every shard (an ordinary logged
        transaction per shard, so per-shard replicas replay it like any
        other record). Reaped rows re-enter their owning shard's READY
        counts, which is exactly what :meth:`rebalance` keys drained-shard
        stealing off — dead-worker backlog becomes stealable cross-shard
        with no extra wiring. Dead shards are skipped (their frozen state
        is recovered wholesale at promote). Returns total rows reaped."""
        return sum(sh.wq.reap_expired(now=now, max_trials=max_trials)
                   for sh in self.shards if sh.alive)

    def autoscale_signals(self, *, now: float = 0.0) -> Dict[str, float]:
        """Union autoscaling signals: counts sum across shards; ages and
        latencies take the max (the pool must cover the worst shard)."""
        sigs = [sh.wq.autoscale_signals(now=now) for sh in self.shards]
        return {
            "pending": float(sum(s["pending"] for s in sigs)),
            "backlog_age_s": max(s["backlog_age_s"] for s in sigs),
            "claim_p95_s": max(s["claim_p95_s"] for s in sigs),
            "running": float(sum(s["running"] for s in sigs)),
        }

    # ------------------------------------------------- cross-shard stealing
    def rebalance(self, *, now: float = 0.0,
                  max_batch: Optional[int] = None) -> int:
        """Cross-shard work stealing: every DRAINED shard (zero READY rows)
        pulls half the richest sibling's READY backlog over the transport.

        The victim's half is marked PRUNED in a logged transaction and the
        thief re-inserts the identical tasks (original ids, original inputs)
        as a NORMAL logged insert — both shards' replicas replay their own
        log to bit-parity, no new record type needed. The prune is only
        PROVISIONAL until the thief's insert acks: if the transport dies
        mid-steal the chunk is rolled back on the victim as a logged
        re-insert (see :meth:`_pull`), so a wire failure can delay a
        migration but never lose a task. Returns tasks moved.

        Migration resets a task's retry counter and submit time (only READY
        rows travel, so no start/end history is lost); the victim keeps a
        PRUNED tombstone row under the same id — :meth:`live_task_ids`
        resolves ids to their live copy.
        """
        # dead shards neither steal nor get robbed: -1 keeps them out of
        # both the drained test and the richest-victim argmax
        totals = [int(sh.wq.ready_counts().sum()) if sh.alive else -1
                  for sh in self.shards]
        moved = 0
        for s, sh in enumerate(self.shards):
            if not sh.alive or totals[s] > 0:
                continue
            victim = int(np.argmax(totals))
            if victim == s or totals[victim] < 2:
                continue
            batch = totals[victim] // 2
            if max_batch is not None:
                batch = min(batch, max_batch)
            got = self._pull(self.shards[victim], sh, batch, now)
            totals[victim] -= got
            totals[s] += got
            moved += got
        return moved

    def _pull(self, victim: Shard, thief: Shard, batch: int,
              now: float) -> int:
        vst = victim.wq.store
        rows = np.nonzero(vst.col("status") == int(Status.READY))[0][:batch]
        if not len(rows):
            return 0
        in_cols = sorted(
            (c for c in vst.cols
             if c.startswith("in") and c[2:].isdigit()),
            key=lambda c: int(c[2:]))
        moved = 0
        for lo in range(0, len(rows), _STEAL_CHUNK_ROWS):
            chunk = rows[lo:lo + _STEAL_CHUNK_ROWS]
            payload = {
                "ids": vst.col("task_id")[chunk],
                "act": vst.col("activity_id")[chunk],
                "parent": vst.col("parent_task")[chunk],
                "dur": vst.col("duration_est")[chunk],
                "dom": np.stack([vst.col(c)[chunk] for c in in_cols], 1)
                if in_cols else None,
            }
            # phase 1 — tombstone the victim's copy (logged) BEFORE the
            # ship, so a task is never claimable on two shards at once.
            # The tombstone is provisional: it only sticks once phase 2
            # (the thief's insert) has the payload in hand.
            victim.wq.prune(chunk)
            try:
                buf = pickle.dumps(payload,
                                   protocol=pickle.HIGHEST_PROTOCOL)
                self._steal_tx.send_bytes(buf)
                wire = self._steal_rx.recv_bytes()
            except (OSError, EOFError):
                # the wire died before the thief acked this chunk: roll
                # the provisional prune back as a NORMAL logged re-insert
                # (same ids, same inputs), so the victim's replicas replay
                # prune+insert to the same live rows and the chunk stays
                # claimable where it was. Remaining chunks are abandoned —
                # the transport is gone.
                self._reinsert(victim, payload, now)
                self.steal_stats.rollbacks += 1
                self.steal_stats.rolled_back_tasks += len(chunk)
                break
            self.steal_stats.wire_bytes += len(wire)
            p = pickle.loads(wire)
            # phase 2 — the thief's insert is the ack that commits the move
            self._reinsert(thief, p, now)
            moved += len(chunk)
        if moved:
            victim.steals_out += 1
            thief.steals_in += 1
            self.steal_stats.batches += 1
            self.steal_stats.tasks += moved
            self.steal_stats.per_shard_in[thief.index] = \
                self.steal_stats.per_shard_in.get(thief.index, 0) + moved
        return moved

    @staticmethod
    def _reinsert(shard: Shard, payload: Dict, now: float) -> None:
        """Materialize a steal payload on ``shard`` as normal logged
        inserts (original ids preserved) — the thief's commit on success,
        the victim's rollback on a dead transport."""
        for a in np.unique(payload["act"]):
            m = payload["act"] == a
            shard.wq.add_tasks(
                int(a), int(m.sum()),
                duration_est=payload["dur"][m],
                domain_in=None if payload["dom"] is None
                else payload["dom"][m],
                parent_task=payload["parent"][m],
                now=now, task_ids=payload["ids"][m])

    # -------------------------------------------------- snapshots / replicas
    def version_vector(self) -> Tuple[int, ...]:
        return tuple(sh.wq.store.version for sh in self.shards)

    def snapshot_vector(self) -> Tuple[SnapshotView, ...]:
        """One immutable snapshot per shard — the consistent cut every
        scatter-gather sweep pins (the distributed analogue of
        ``SteeringEngine.snapshot_scope``)."""
        return tuple(sh.wq.store.snapshot_view() for sh in self.shards)

    def _scatter_map(self, fn: Callable[[int], object],
                     concurrent_scatter: bool = True) -> List[object]:
        """Run ``fn(shard_index)`` for every shard — on the persistent
        scatter pool when available (wall ≈ max(shard)), else serially.
        The caller blocks until every shard returned, so per-shard log
        staging on pool threads happens while the producer thread is
        parked — the TxnLog single-producer contract holds per shard."""
        idxs = range(self.num_shards)
        if self._scatter is None or not concurrent_scatter:
            return [fn(s) for s in idxs]
        return list(self._scatter.map(fn, idxs))

    def replica_vector(self, *, concurrent_scatter: bool = True
                       ) -> Tuple[SnapshotView, ...]:
        """Snapshot vector cut from the per-shard REPLICAS (analyst-side
        HTAP: sweeps run off the primaries' claim path). The per-shard
        sync+snapshot requests scatter concurrently — independent
        replicators, disjoint logs."""
        def one(s: int) -> SnapshotView:
            sh = self.shards[s]
            if sh.replicator is None:
                raise ValueError("shard has no replicator "
                                 "(construct with replicate=...)")
            sh.replicator.sync()
            return sh.replicator.snapshot_view()
        return tuple(self._scatter_map(one, concurrent_scatter))

    def sync_replicas(self, *, concurrent_scatter: bool = True
                      ) -> Tuple[int, ...]:
        """Catch every live shard's replicas up CONCURRENTLY, pinned at
        the version vector cut on the calling thread before the scatter.
        Returns that vector — the consistent cut a subsequent
        ``remote_sweep(..., versions=vec, sync=False)`` analyzes (how the
        executor splits the producer-thread sync from the analyst-thread
        scatter). Dead shards are skipped exactly as :meth:`compact`
        skips them (their frozen log is the promote WAL), but keep their
        version entry."""
        versions = self.version_vector()

        def one(s: int) -> None:
            sh = self.shards[s]
            if sh.alive and sh.replicator is not None:
                sh.replicator.sync(upto_version=versions[s])
        self._scatter_map(one, concurrent_scatter)
        return versions

    def compact(self) -> int:
        """Per-shard log compaction (each shard's consumer floor governs).
        A dead shard's log is its WAL — frozen until promote drains it —
        so compaction only runs on live shards."""
        return sum(sh.wq.compact_log() for sh in self.shards if sh.alive)

    def consumer_lags(self) -> Dict[str, int]:
        """Union of per-shard consumer lags, keys namespaced by shard."""
        out: Dict[str, int] = {}
        for s, sh in enumerate(self.shards):
            for name, lag in sh.wq.consumer_lags().items():
                out[f"shard{s}:{name}"] = lag
        return out

    # ------------------------------------------------- supervision / failover
    def attach_supervision(self, workflow, *, fanout: int = 1) -> None:
        """Install a Supervisor + SecondarySupervisor pair on every shard,
        so expansion state survives a primary promote (the ``expanded``
        column rides the shard store, hence the replica, hence the
        promoted WorkQueue — ``SecondarySupervisor.promote(wq)`` is exact).

        Call :meth:`sync_secondaries` on the driving cadence so the shadow
        cursors track the primaries. Cross-shard caveat: ``Supervisor``
        allocates ids from the SHARD-LOCAL counter, which breaks global
        hash routing for seeding and for multi-activity expansion — seed
        through :meth:`add_tasks` and keep sharded workflows
        single-activity (:meth:`expand_all` enforces this; cross-shard
        child routing is a documented ROADMAP residual)."""
        from repro_torch.core.supervisor import SecondarySupervisor, Supervisor
        for sh in self.shards:
            sh.supervisor = Supervisor(sh.wq, workflow, fanout=fanout)
            sh.secondary = SecondarySupervisor(sh.supervisor)

    def sync_secondaries(self) -> None:
        """Refresh every live shard's shadow supervisor state."""
        for sh in self.shards:
            if sh.alive and sh.secondary is not None:
                sh.secondary.sync()

    def expand_all(self, *, now: float = 0.0) -> int:
        """Run dependency expansion on every live shard's supervisor."""
        total = 0
        for sh in self.shards:
            if not sh.alive or sh.supervisor is None:
                continue
            if sh.supervisor.workflow.num_activities > 1:
                raise ValueError(
                    "per-shard expansion requires a single-activity "
                    "workflow: Supervisor.expand allocates child ids from "
                    "the shard-local counter, which breaks global hash "
                    "routing — route children through ShardRouter."
                    "add_tasks instead")
            total += sh.supervisor.expand(now=now)
        return total

    def fail_shard(self, shard: int) -> None:
        """Simulate shard ``shard``'s primary dying: the node stops serving
        claims, inserts, reaps, steals, and replica syncs. Its in-memory
        store is considered LOST; what survives is the txn log tail (the
        node's WAL) and the replica state — exactly what
        :meth:`promote_shard` recovers from. Its supervisor dies with it
        (the secondary shadow survives). Idempotent; the other shards'
        claim loops are untouched."""
        sh = self.shards[shard]
        sh.alive = False
        if sh.supervisor is not None:
            sh.supervisor.crash()

    def promote_shard(self, shard: int) -> WorkQueue:
        """Fail the shard over onto its most-caught-up replica: elect via
        the existing ``Replicator.promote()`` (which drains the surviving
        log tail, so not one committed transaction is lost, and requeues
        RUNNING rows — their workers died with the primary), rebuild the
        shard's WorkQueue around the promoted store, re-register a fresh
        replicator from the router's replication policy, and promote the
        shard's SecondarySupervisor (generation bumped) onto the new
        queue. The promoted queue claims on the device of the queue it
        replaces, with the router's ``device_claim`` (the flag at promote
        time when that is None). Returns the promoted WorkQueue; the shard
        is serving again when this returns.

        Raises :class:`UnrecoverableShardError` when there is nothing to
        promote — no replicator, or every replica in the group is dead
        (``AllReplicasDeadError``); a durable checkpoint is the only way
        back at that point."""
        from repro_torch.core.replication import AllReplicasDeadError
        sh = self.shards[shard]
        if sh.replicator is None:
            raise UnrecoverableShardError(
                f"shard {shard} has no replicator to promote "
                "(construct the router with replicate=...)")
        try:
            new_wq = sh.replicator.promote()
        except AllReplicasDeadError as e:
            raise UnrecoverableShardError(
                f"shard {shard} lost its primary and every replica — "
                f"restore from a checkpoint: {e}") from e
        sh.replicator = None          # promote() already closed it
        if self._device_claim is not None:
            # the router's own choice holds across a failover; only a
            # router built with None follows the flag at promote time
            new_wq.device_claim = self._device_claim
            if new_wq.device_claim:
                from repro_torch.device import resolve_device
                new_wq.device = resolve_device(new_wq.device)
        self._adopt(sh, new_wq)
        return new_wq

    def _adopt(self, sh: Shard, wq: WorkQueue) -> None:
        """Swap a shard's primary for a promoted/restored WorkQueue:
        re-arm its replicator from the router's replication policy and
        promote its secondary supervisor onto the new queue."""
        if sh.replicator is not None:
            sh.replicator.close()
        sh.wq = wq
        sh.replicator = None
        if self._replicate is not None:
            from repro_torch.core.replication import make_replicator
            sh.replicator = make_replicator(
                wq, self._replicate, replicas=self._replicas,
                sync_every=self._sync_every, transport=self._transport,
                account_encoded=False)
        sh.alive = True
        if sh.secondary is not None:
            from repro_torch.core.supervisor import SecondarySupervisor
            sh.supervisor = sh.secondary.promote(wq)
            sh.secondary = SecondarySupervisor(sh.supervisor)

    @classmethod
    def from_checkpoint(cls, shard_states, *,
                        replicate: Optional[str] = None,
                        replicas: int = 1,
                        sync_every: int = 64,
                        transport: Optional[str] = None,
                        device_claim: Optional[bool] = None,
                        capacity: int = 1 << 16,
                        device="cuda") -> "ShardRouter":
        """Rebuild a router from per-shard restored state, in shard order:
        ``shard_states`` is one ``(store, meta)`` pair per shard as cut by
        ``Checkpointer.save`` (meta carries ``num_workers`` / ``version`` /
        ``log_len``). Each shard's WorkQueue resumes with its log offset
        and compaction horizon pinned at the checkpoint's version vector,
        and replicators are re-armed from the given policy — the restored
        run's scatter-gather sweeps are bit-identical to the pre-crash cut.
        """
        if not shard_states:
            raise ValueError("from_checkpoint needs at least one shard")
        wps = int(shard_states[0][1]["num_workers"])
        r = cls(len(shard_states), wps, capacity=capacity,
                replicate=None, device_claim=device_claim, device=device)
        r._replicate = replicate
        r._replicas = replicas
        r._sync_every = sync_every
        r._transport = transport
        next_id = 0
        for sh, (store, meta) in zip(r.shards, shard_states):
            if int(meta["num_workers"]) != wps:
                raise ValueError("shards disagree on workers_per_shard")
            wq = WorkQueue(wps, store=store, device_claim=device_claim,
                           device=device)
            used = store.col("status") != int(Status.EMPTY)
            if used.any():
                mx = int(store.col("task_id")[used].max())
                wq._next_task_id = mx + 1
                next_id = max(next_id, mx + 1)
            wq.log.base = int(meta["log_len"])
            wq.log.horizon_version = int(meta["version"])
            r._adopt(sh, wq)
        r._next_task_id = next_id
        return r

    # ------------------------------------------------ scatter-gather sweep
    def run_all(self, now: float,
                views: Optional[Sequence[SnapshotView]] = None,
                horizon: float = 60.0) -> Dict[str, object]:
        """Distributed Q1-Q7 sweep: per-shard partial aggregates merged into
        the single-primary result shape.

        ``views`` pins the sweep at an explicit version vector (default: cut
        one now). Differences from ``SteeringEngine.run_all``: ``q7`` holds
        global TASK IDS (sorted) rather than store rows — rows are
        shard-local and meaningless globally — and ``version`` is the
        version vector (a list). Everything else is bit-identical to a
        W-worker single primary over the same data.

        The reduction is split into two PURE pieces so the per-shard half
        can run anywhere (an analyst thread here, or inside a replica
        process via :meth:`remote_sweep`):
        :func:`repro_torch.core.steering.sweep_partials` per view, then
        :func:`merge_partials` over the results.
        """
        if views is None:
            views = self.snapshot_vector()
        if len(views) != self.num_shards:
            raise ValueError(f"version vector has {len(views)} entries, "
                             f"expected {self.num_shards}")
        return merge_partials(
            sweep_partials(v, self.workers_per_shard, now, horizon)
            for v in views)

    @staticmethod
    def comparable(result: Dict[str, object]) -> Dict[str, object]:
        """Strip the version field (scalar vs vector) for sweep parity
        fingerprints."""
        return {k: v for k, v in result.items() if k != "version"}

    @staticmethod
    def oracle_normalize(result: Dict[str, object],
                         view: SnapshotView) -> Dict[str, object]:
        """Map a single-primary ``SteeringEngine.run_all`` result into the
        router's shape: q7 store rows -> sorted global task ids."""
        out = ShardRouter.comparable(result)
        rows = np.asarray(out.get("q7", []), np.int64)
        out["q7"] = np.sort(view.col("task_id")[rows]).tolist()
        return out

    # ----------------------------------------------------- remote analysts
    def remote_sweep(self, now: float, *, horizon: float = 60.0,
                     versions: Optional[Sequence[int]] = None,
                     sync: bool = True,
                     concurrent_scatter: bool = True,
                     shard_delay_s: Optional[Sequence[float]] = None
                     ) -> Dict[str, object]:
        """Concurrent scatter-gather of the FULL Q1-Q7 sweep through the
        per-shard replica processes: each shard's replicator runs
        :func:`~repro_torch.core.steering.sweep_partials` INSIDE its replica
        process and ships back only the partial aggregates;
        :func:`merge_partials` combines them here into a result
        bit-identical to :meth:`run_all` (and hence to a single-primary
        oracle) at the same version vector.

        ``sync=True`` (default) pins ``versions`` to the current version
        vector and catches each shard's replica up to it inside the
        scatter. Callers that must keep log staging on the producer
        thread (the executor's analyst pool) pass the vector returned by
        :meth:`sync_replicas` with ``sync=False`` — the scatter then only
        issues the log-free partial-sweep requests. Each partial's view
        version is hard-checked against the pinned vector. Per-shard
        walls land in ``last_scatter_wall_s`` (straggler spread via
        :meth:`scatter_spread_s`); ``concurrent_scatter=False`` is the
        serial baseline arm the e_sharded benchmark compares against.

        ``shard_delay_s`` injects a per-shard modeled data-node RPC
        latency, slept inside each replica process before its sweep —
        the latency-regime knob of the e_sharded fan-out benchmark
        (same role as ``run_baseline``'s ``access_latency_s``: the
        paper's shards are separate hosts behind a NIC) and a straggler
        injector for spread measurements. ``None`` (production) injects
        nothing.

        Raises :class:`DeadShardError` when any shard is down — a merged
        result silently missing a shard would misreport global state —
        and ``ValueError`` when a shard's replicator cannot run remote
        partial sweeps (requires ``replicate='remote'`` or
        ``'shipped'``)."""
        for s, sh in enumerate(self.shards):
            if not sh.alive:
                raise DeadShardError(
                    f"shard {s} is down (failed primary, not yet "
                    f"promoted) — promote_shard({s}) before sweeping, or "
                    "run_all over pinned snapshots of the frozen stores")
            if sh.replicator is None or not hasattr(
                    sh.replicator, "remote_sweep_partials"):
                raise ValueError(
                    "remote_sweep requires replicate='remote' (or "
                    "'shipped'): the partial sweeps run inside per-shard "
                    "replica processes")
        if versions is None:
            versions = self.version_vector()

        def one(s: int) -> Tuple[Dict[str, object], float]:
            t0 = time.perf_counter()
            sh = self.shards[s]
            if sync:
                sh.replicator.sync(upto_version=versions[s])
            part = sh.replicator.remote_sweep_partials(
                now, horizon=horizon,
                delay_s=0.0 if shard_delay_s is None
                else float(shard_delay_s[s]))
            return part, time.perf_counter() - t0
        results = self._scatter_map(one, concurrent_scatter)
        self.last_scatter_wall_s = [w for _, w in results]
        parts = [p for p, _ in results]
        for s, p in enumerate(parts):
            if int(p["version"]) != int(versions[s]):
                raise RuntimeError(
                    f"shard {s} replica answered the partial sweep at "
                    f"v{p['version']}, expected pinned v{versions[s]}")
        return merge_partials(parts)

    def scatter_spread_s(self) -> float:
        """Straggler signal of the last remote scatter: slowest minus
        fastest per-shard wall (the shard-level analogue of
        ``ReplicaGroup.member_spread_s``)."""
        return (max(self.last_scatter_wall_s)
                - min(self.last_scatter_wall_s))

    # -------------------------------------------------------------- teardown
    def check_invariants(self) -> None:
        for sh in self.shards:
            sh.wq.check_invariants()
        live = self.live_task_ids()
        if len(np.unique(live)) != len(live):
            raise AssertionError("task id owned live by two shards")

    def close(self) -> None:
        """Release every shard's replicator, the scatter pool, and the
        steal endpoints. Idempotent — a second close is a no-op — and
        safe after :meth:`fail_shard`/:meth:`promote_shard` (promote
        releases the old replicator and re-arms a fresh one; each armed
        replicator is detached before its single close, so nothing is
        double-closed)."""
        if self._closed:
            return
        self._closed = True
        for sh in self.shards:
            rep, sh.replicator = sh.replicator, None
            if rep is not None:
                rep.close()
        if self._scatter is not None:
            self._scatter.shutdown(wait=False)
            self._scatter = None
        self._steal_tx.close()
        self._steal_rx.close()
