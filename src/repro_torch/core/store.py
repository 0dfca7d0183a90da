"""In-memory columnar store (struct-of-arrays) with partition views.

The accelerator-side adaptation of the paper's MySQL-Cluster data nodes:
execution / domain / provenance columns live in ONE preallocated SoA region,
hash-partitioned by ``worker_id``. The authoritative copy is host-resident
(the control plane mutates it transactionally); hot columns mirror to a torch
device for analytical steering reductions and for the claim kernel.

Updates go through ``apply`` with a transaction record so the txn log
(transactions.py) can replay them on replicas and after restarts.

HTAP snapshot isolation
-----------------------
``snapshot_view()`` returns an immutable :class:`SnapshotView` of the store at
the current committed version in O(columns) time: the live arrays are frozen
(``writeable = False``) and handed to the view; the NEXT transactional write to
a frozen column copies it first (column-granular copy-on-write). Analytical
steering sweeps therefore read a consistent version while claims keep mutating
the live store — the paper's "same store, OLTP claims + OLAP scans" argument
without torn reads. Snapshot creation and transaction commits serialize on one
lock so a view can never observe half a committed batch.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core.schema import Column, Status, wq_schema

# Default claim-lease duration (seconds). Lives on the store (not the
# WorkQueue) so replicas restored from a snapshot derive the SAME
# ``expires_at = now + lease_s`` when replaying claim records — lease columns
# stay bit-identical across the wire with zero new frame fields.
DEFAULT_LEASE_S = 60.0


def _build_id_index(tid: np.ndarray) -> np.ndarray:
    """``id_to_row`` gather table: arr[task_id] == row, -1 for unknown ids."""
    hi = int(tid.max(initial=-1)) + 1
    idx = np.full(max(hi, 1), -1, np.int64)
    valid = tid >= 0
    idx[tid[valid]] = np.nonzero(valid)[0]
    return idx


def _device_view(source, names: Sequence[str], device
                 ) -> Dict[str, "torch.Tensor"]:
    """Copy the named columns of a store or view to ``device`` (dtype kept:
    int32 status/worker ids, float64 times). torch is imported here, not
    with the module: a replica process holds stores and never a tensor."""
    import torch

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    return {n: torch.tensor(source.col(n), device=dev) for n in names}


class SnapshotView:
    """Immutable, internally consistent view of a store version.

    Holds references to the store's frozen column arrays (zero-copy at
    creation); exposes the read-side query API of :class:`ColumnStore` so the
    steering engine can run against either interchangeably.
    """

    def __init__(self, cols: Dict[str, np.ndarray], n_rows: int,
                 version: int, lease_s: float = DEFAULT_LEASE_S):
        self._cols = cols
        self.n_rows = n_rows
        self.version = version
        self.lease_s = float(lease_s)
        self._id_index: Optional[np.ndarray] = None

    def col(self, name: str) -> np.ndarray:
        return self._cols[name][: self.n_rows]

    def where(self, **eq) -> np.ndarray:
        mask = np.ones(self.n_rows, bool)
        for name, val in eq.items():
            mask &= self.col(name) == val
        return np.nonzero(mask)[0]

    def partition(self, worker_id: int) -> np.ndarray:
        return self.where(worker_id=worker_id)

    def device_view(self, names: Sequence[str], device="cuda"):
        return _device_view(self, names, device)

    def id_index(self) -> np.ndarray:
        """``id_to_row`` gather table at this version (computed lazily once —
        the view is immutable, so no invalidation is ever needed)."""
        if self._id_index is None:
            self._id_index = _build_id_index(self.col("task_id"))
        return self._id_index

    def stats(self) -> Dict[int, int]:
        return _status_stats(self.col("status"))


def _status_stats(status: np.ndarray) -> Dict[int, int]:
    """One bincount instead of one full-column scan per Status member."""
    c = np.bincount(status, minlength=int(max(Status)) + 1)
    return {int(s): int(c[int(s)]) for s in Status}


class ColumnStore:
    def __init__(self, schema: Optional[List[Column]] = None,
                 capacity: int = 1 << 16):
        self.schema = schema or wq_schema()
        self.capacity = capacity
        self.cols: Dict[str, np.ndarray] = {
            c.name: np.full(capacity, c.default, dtype=c.dtype)
            for c in self.schema}
        self.n_rows = 0
        self.version = 0          # bumped per committed transaction
        self.lease_s = DEFAULT_LEASE_S   # claim-lease duration (schema.py)
        self.blobs: Dict[int, Dict[str, Any]] = {}   # task_id -> raw pointers
        # serializes commits against snapshot creation (snapshot isolation);
        # reentrant so insert -> _grow nests safely
        self._mu = threading.RLock()
        self._id_index: Optional[np.ndarray] = None   # task_id -> row cache
        self._id_index_rows = -1

    # --------------------------------------------------------------- writes
    def _writable(self, name: str) -> np.ndarray:
        """Column array safe to mutate: copy-on-write if a snapshot holds it."""
        arr = self.cols[name]
        if not arr.flags.writeable:
            arr = arr.copy()
            self.cols[name] = arr
        return arr

    # ------------------------------------------------------------------ rows
    def insert(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        with self._mu:
            n = len(next(iter(rows.values())))
            if self.n_rows + n > self.capacity:
                self._grow(max(self.capacity * 2, self.n_rows + n))
            idx = np.arange(self.n_rows, self.n_rows + n)
            for name, vals in rows.items():
                self._writable(name)[idx] = vals
            self.n_rows += n
            self.version += 1
            self._id_index_rows = -1
            return idx

    def _grow(self, new_cap: int):
        with self._mu:
            for c in self.schema:
                new = np.full(new_cap, c.default, dtype=c.dtype)
                new[: self.n_rows] = self.cols[c.name][: self.n_rows]
                self.cols[c.name] = new
            self.capacity = new_cap

    def update(self, idx: np.ndarray, **values) -> None:
        with self._mu:
            for name, vals in values.items():
                self._writable(name)[idx] = vals
            self.version += 1

    # --------------------------------------------------------------- queries
    def col(self, name: str) -> np.ndarray:
        return self.cols[name][: self.n_rows]

    def where(self, **eq) -> np.ndarray:
        """Row indices matching all column==value predicates."""
        mask = np.ones(self.n_rows, bool)
        for name, val in eq.items():
            mask &= self.col(name) == val
        return np.nonzero(mask)[0]

    def partition(self, worker_id: int) -> np.ndarray:
        """The paper's 'WHERE worker_id = i' partition view."""
        return self.where(worker_id=worker_id)

    def id_index(self) -> np.ndarray:
        """``id_to_row`` lookup: arr[task_id] == row, -1 for unknown ids.

        Cached per insert-generation (task_id is immutable after insert), so
        provenance walks (Q7, derivation paths) gather instead of dict-probing.
        """
        if self._id_index_rows != self.n_rows:
            self._id_index = _build_id_index(self.col("task_id"))
            self._id_index_rows = self.n_rows
        return self._id_index

    # ---------------------------------------------------------- transactions
    @contextlib.contextmanager
    def txn(self):
        """Commit boundary: writes inside the block form one atomic batch.

        Holds the commit lock across the block so ``snapshot_view`` (and other
        committers) serialize at batch granularity — a snapshot can never see
        e.g. a status flip without its matching start_time write. Nests freely
        (RLock); individual insert/update calls are single-op batches.
        """
        with self._mu:
            yield self

    # ------------------------------------------------------------ device I/O
    def device_view(self, names: Sequence[str], device="cuda"):
        """torch mirror of selected columns on ``device`` (for steering /
        claim kernels)."""
        return _device_view(self, names, device)

    # ------------------------------------------------------------- snapshots
    def snapshot_view(self) -> SnapshotView:
        """O(columns) immutable view at the current committed version.

        Freezes the live arrays; the next committed write to a frozen column
        copies it (COW), so the view keeps observing this version forever.
        """
        with self._mu:
            for name, arr in self.cols.items():
                arr.flags.writeable = False
            return SnapshotView(dict(self.cols), self.n_rows, self.version,
                                lease_s=self.lease_s)

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "n_rows": self.n_rows,
                "version": self.version,
                "cols": {n: self.cols[n][: self.n_rows].copy()
                         for n in self.cols},
                "blobs": dict(self.blobs),
                "lease_s": self.lease_s,
            }

    @classmethod
    def from_view(cls, view: SnapshotView,
                  schema: Optional[List[Column]] = None) -> "ColumnStore":
        """Materialize a MUTABLE store from an immutable snapshot view.

        This is the replica-side restore step of delta catch-up: copy the
        view's columns into a fresh store at the view's version, then replay
        the txn-log tail (``replication.replay``) on top. O(rows x cols)
        once at restore time; all subsequent syncs are O(delta).
        """
        st = cls(schema, capacity=max(1 << 10, int(view.n_rows * 2)))
        n = view.n_rows
        for name in st.cols:
            st.cols[name][:n] = view.col(name)
        st.n_rows = n
        st.version = view.version
        st.lease_s = getattr(view, "lease_s", DEFAULT_LEASE_S)
        return st

    def set_version(self, version: int) -> None:
        """Pin the committed version after replaying a log record.

        Replaying one record may issue several internal writes (each bumping
        ``version`` by one); aligning to the record's ``store_version``
        afterwards keeps replica versions bit-identical to the primary's, so
        version-keyed equality checks (time travel, sweep parity) hold.
        """
        with self._mu:
            self.version = int(version)

    def row_nbytes(self) -> int:
        """Bytes per row across all schema columns (full-copy cost unit)."""
        return int(sum(c.dtype.itemsize for c in self.schema))

    @classmethod
    def restore(cls, snap: Dict[str, Any],
                schema: Optional[List[Column]] = None) -> "ColumnStore":
        st = cls(schema, capacity=max(1 << 10, int(snap["n_rows"] * 2)))
        n = snap["n_rows"]
        for name, vals in snap["cols"].items():
            st.cols[name][:n] = vals
        st.n_rows = n
        st.version = snap["version"]
        st.blobs = dict(snap["blobs"])
        st.lease_s = float(snap.get("lease_s", DEFAULT_LEASE_S))
        return st

    # ------------------------------------------------------------- integrity
    def stats(self) -> Dict[int, int]:
        return _status_stats(self.col("status"))
