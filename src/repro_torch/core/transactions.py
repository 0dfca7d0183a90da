"""Append-only transaction log: replication feed + crash recovery delta.

Every WorkQueue mutation appends a record; replicas (replication.py) consume
the tail; checkpoints persist (snapshot, log-offset) so restart = restore
snapshot + replay tail — the paper's in-memory-DBMS durability story
("in-memory data nodes with occasional on-disk checkpoints").

Records carry the store version they committed at (``store_version``) so a
consumer can align the log with a :class:`~repro.core.store.SnapshotView`:
``tail_for_version(v)`` is exactly the delta to replay ON TOP of a snapshot
taken at version ``v`` — the foundation for txn-log replay onto snapshots and
multi-host replica catch-up.

Payloads are REPLAYABLE: each record carries the row indices and column
values its op wrote (the store is append-only, so primary row indices are
valid verbatim on any replica that replayed the same prefix). ``store_version``
is monotone non-decreasing across records — commits serialize on the store
lock and append inside it — so the version-aligned lookups bisect instead of
scanning the whole log.

Compaction (consumer-offset-aware truncation)
---------------------------------------------
Replayable payloads deep-copy written row data, so an unbounded log pays
~2x task-metadata memory on long runs. Consumers (checkpointer, replicas)
``register_consumer`` + ``ack`` the absolute offset they have durably
consumed; ``truncate`` drops the prefix every registered consumer is past.
Record indices are ABSOLUTE: ``base`` is the index of the first retained
record, so offsets held by consumers stay valid across truncations and
``len(log)`` keeps returning the absolute end offset. Lookups that would
need dropped records (``tail_for_version`` / ``records_between`` below the
compaction horizon) raise :class:`LogCompactedError` instead of silently
returning an incomplete delta — time-travel from genesis degrades to
"replay since the last checkpoint" (pass a base snapshot at or after the
horizon).
"""
from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class LogCompactedError(RuntimeError):
    """The requested records were dropped by ``TxnLog.truncate``.

    Raised instead of returning an INCOMPLETE delta. Recover by replaying
    from a snapshot at or after ``TxnLog.horizon_version`` (e.g. the last
    checkpoint) rather than from genesis.
    """


@dataclass
class Txn:
    version: int                     # log sequence number
    op: str
    payload: Dict[str, Any]
    wall_time: float
    store_version: int = -1          # ColumnStore.version at commit time
    # hot-plane locator: the columnar plane this record's fields were
    # accumulated into at append time, and its index there (replay slices
    # the plane instead of re-extracting payload dicts record by record)
    plane: Optional["_HotPlane"] = field(default=None, repr=False,
                                         compare=False)
    pidx: int = -1
    _nbytes: int = field(default=-1, repr=False, compare=False)

    def payload_nbytes(self) -> int:
        """Wire size of this record's payload (what delta-shipping costs):
        array bytes plus a small fixed charge per scalar field. Cached on
        first call — replicas account it once per sync."""
        if self._nbytes < 0:
            total = 0
            for v in self.payload.values():
                if isinstance(v, np.ndarray):
                    total += v.nbytes
                elif isinstance(v, dict):
                    total += sum(a.nbytes if isinstance(a, np.ndarray) else 8
                                 for a in v.values())
                else:
                    total += 8
            self._nbytes = total
        return self._nbytes


_VERSION_FLOOR = -(1 << 62)


class _GrowBuf:
    """Amortized-doubling typed append buffer (1D, or 2D row blocks).

    ``width`` distinguishes by identity, not truthiness: ``width=0`` is a
    legal 2-D buffer of zero-wide rows (a ``domain_out`` with no columns),
    and collapsing it to 1-D would crash ``shape[1]`` probes mid-append.
    """

    __slots__ = ("data", "n")

    def __init__(self, dtype, width: Optional[int] = None, cap: int = 256):
        self.data = np.empty(cap if width is None else (cap, width), dtype)
        self.n = 0

    def _grow(self, need: int) -> None:
        shape = list(self.data.shape)
        shape[0] = max(self.data.shape[0] * 2, need)
        new = np.empty(tuple(shape), self.data.dtype)
        new[: self.n] = self.data[: self.n]
        self.data = new

    def append(self, v) -> None:
        if self.n == self.data.shape[0]:
            self._grow(self.n + 1)
        self.data[self.n] = v
        self.n += 1

    def extend(self, arr) -> None:
        k = len(arr)
        need = self.n + k
        if need > self.data.shape[0]:
            self._grow(need)
        self.data[self.n: need] = arr
        self.n = need

    def view(self, lo: int, hi: int) -> np.ndarray:
        return self.data[lo: hi]

    def trim_front(self, k: int, shift=None) -> None:
        """Drop the first k valid entries (compaction), optionally
        subtracting ``shift`` from the survivors (offset re-basing).

        Allocates a FRESH buffer instead of moving data in place: views
        handed out before the trim (``slice_fields`` captures staged for
        the pipelined shipper on another thread) keep aliasing the OLD
        buffer, whose contents stay frozen — compaction must never mutate
        bytes a concurrent encoder may still be reading.
        """
        n = self.n - k
        shape = list(self.data.shape)
        new = np.empty(tuple(shape), self.data.dtype)
        if shift is None:
            new[:n] = self.data[k: self.n]
        else:
            new[:n] = self.data[k: self.n] - shift
        self.data = new
        self.n = n


class _HotPlane:
    """Columnar accumulation of one hot op's replayable fields.

    The log's dominant ops (claims, finishes) are appended thousands of
    times with tiny per-record payloads; replaying them record-at-a-time —
    or even batch-extracting the payload dicts at replay time — pays a
    per-record Python toll. The plane pays a small fixed cost at APPEND
    time instead (one typed-buffer append per field), so a consecutive run
    of records becomes O(1) array slices at replay: row indices are one
    contiguous view, per-record scalars repeat out by the segment lengths.
    ``off`` has n+1 entries (cumulative row counts); ``base`` advances on
    truncation so record ``pidx`` locators stay valid.

    Memory: the plane DUPLICATES the hot fields the frozen payload dict
    already copied (the buffers must stay contiguous across payload
    lifetimes, so they cannot alias the payload arrays; ``trim_front``
    compacts into a fresh allocation so already-captured views survive
    compaction unchanged). The overhead is ~rows*8B + ~24B/record for
    the dominant ops and is bounded by the same consumer-floor truncation
    as the record list itself.
    """

    __slots__ = ("base", "n", "off", "rows", "now", "worker",
                 "dom_off", "dom", "dom_flag")

    def __init__(self, has_worker: bool = False, has_dom: bool = False):
        self.base = 0
        self.n = 0
        self.off = _GrowBuf(np.int64)
        self.off.append(0)
        self.rows = _GrowBuf(np.int64)
        self.now = _GrowBuf(np.float64)
        self.worker = _GrowBuf(np.int32) if has_worker else None
        self.dom_off = _GrowBuf(np.int64) if has_dom else None
        if has_dom:
            self.dom_off.append(0)
        self.dom: Optional[_GrowBuf] = None       # allocated on first dom
        # 1 per entry that CARRIES domain outputs, even when a width drift
        # kept them out of the dom buffer: a run whose dom row-range is
        # empty but whose flags are not must replay via the dict path —
        # and only THAT run pays the fallback, not the whole plane
        self.dom_flag = _GrowBuf(np.int8) if has_dom else None

    def add(self, payload: Dict[str, Any]) -> int:
        """Accumulate one record's fields; returns its plane index."""
        # validate AND convert every field before the first buffer mutation:
        # a malformed payload must raise here, leaving the plane untouched —
        # a partial append would silently misalign every later run slice
        rows = np.asarray(payload["rows"], np.int64)
        if rows.ndim != 1:
            raise ValueError("plane rows must be 1-D")
        now = float(payload["now"])
        w = int(payload["worker"]) if self.worker is not None else None
        dom = payload.get("domain_out") if self.dom_off is not None else None
        if dom is not None:
            dom = np.asarray(dom, np.float64)
            if dom.ndim != 2:
                raise ValueError("plane domain_out must be 2-D")
        dwidth = dom.shape[1] if dom is not None else 0
        self.rows.extend(rows)
        self.off.append(self.rows.n)
        self.now.append(now)
        if self.worker is not None:
            self.worker.append(w)
        if self.dom_off is not None:
            if dom is not None:
                if self.dom is None:
                    self.dom = _GrowBuf(np.float64, width=dwidth)
                if dwidth == self.dom.data.shape[1]:
                    self.dom.extend(dom)
                # else: width drift — the entry's flag stays set while its
                # dom rows stay out of the buffer, so its run (and only its
                # run) replays via the dict path
            self.dom_flag.append(0 if dom is None else 1)
            self.dom_off.append(self.dom.n if self.dom is not None else 0)
        self.n += 1
        return self.base + self.n - 1

    def slice_fields(self, lo: int, hi: int) -> Dict[str, Any]:
        """Raw field views of plane entries [lo, hi) — the wire codec's
        zero-copy export (and the replay fast-path's source arrays).

        ``off``/``dom_off`` carry hi-lo+1 entries and are NOT re-based:
        consumers subtract ``off[0]`` themselves (the codec re-bases into
        the frame, replay indexes the shared buffer directly). ``dom`` is
        the 2-D output-row block for the slice's dom range, or None when
        the plane never saw a domain payload.
        """
        off = self.off.view(lo, hi + 1)
        out: Dict[str, Any] = {
            "off": off,
            "rows": self.rows.view(int(off[0]), int(off[-1])),
            "now": self.now.view(lo, hi),
        }
        if self.worker is not None:
            out["worker"] = self.worker.view(lo, hi)
        if self.dom_off is not None:
            doff = out["dom_off"] = self.dom_off.view(lo, hi + 1)
            out["dom_flag"] = self.dom_flag.view(lo, hi)
            out["dom"] = None if self.dom is None else \
                self.dom.view(int(doff[0]), int(doff[-1]))
        return out

    def truncate(self, upto_pidx: int) -> None:
        """Drop plane entries with index < upto_pidx (log compaction).

        Every buffer re-bases via ``trim_front``'s fresh-allocation path:
        views captured before the truncate stay valid against the old
        buffers (see :meth:`_GrowBuf.trim_front`).
        """
        d = min(max(upto_pidx - self.base, 0), self.n)
        if d == 0:
            return
        shift = int(self.off.data[d])
        self.rows.trim_front(shift)
        self.off.trim_front(d, shift=shift)
        self.now.trim_front(d)
        if self.worker is not None:
            self.worker.trim_front(d)
        if self.dom_off is not None:
            dshift = int(self.dom_off.data[d])
            if self.dom is not None:
                self.dom.trim_front(dshift)
            self.dom_off.trim_front(d, shift=dshift)
            self.dom_flag.trim_front(d)
        self.base += d
        self.n -= d


# hot ops get a columnar plane: (has_worker, has_dom) per op. Claims and
# finishes dominate real logs (paper Fig. 12), so these three cover the
# replay hot path; rare ops (fail, resize, steering) stay dict-payload-only.
_HOT_OPS = {
    "claim": (True, False),
    "claim_all": (False, False),
    "finish": (False, True),
}


def plane_run(recs: Sequence["Txn"]):
    """(plane, lo, hi) when a same-op run lives contiguously in one plane.

    Shared by batched replay (plane-slice fast path) and the wire codec
    (hot-frame eligibility): both must route a run to the dict-payload path
    whenever its plane entries are gone or split. Records held by a caller
    across a ``TxnLog.truncate`` may predate the plane's base — their plane
    entries were trimmed, so they must replay/encode from their (intact)
    frozen payloads; a negative offset here would silently slice the wrong
    retained entries.
    """
    first, last = recs[0], recs[-1]
    plane = first.plane
    if plane is None or last.plane is not plane \
            or last.pidx - first.pidx + 1 != len(recs) \
            or first.pidx < plane.base:
        return None
    return plane, first.pidx - plane.base, last.pidx + 1 - plane.base


class TxnLog:
    """Threading contract: record/plane MUTATION (append, truncate) and
    record READS (tail/slice/tail_for_version/replay over plane views)
    belong to the producer thread — the WorkQueue appends inside the store
    commit lock and the executor truncates between ticks on that same
    thread. Only the CONSUMER-OFFSET map is cross-thread safe
    (``_consumers_mu``): the async checkpoint writer acks from its own
    thread after the durable publish.
    """

    def __init__(self):
        self.records: List[Txn] = []
        # absolute index of records[0]: truncate drops the consumed prefix
        # and advances base, so consumer offsets / record.version stay valid
        self.base = 0
        # max store_version among DROPPED records: deltas anchored strictly
        # below this horizon are incomplete and raise LogCompactedError
        self.horizon_version = _VERSION_FLOOR
        self._consumers: Dict[str, int] = {}
        # acks arrive from other threads (the checkpointer's async writer
        # acks after its atomic publish) while truncate/consumer_floor read
        # the map on the producer thread — serialize map access
        self._consumers_mu = threading.Lock()
        self._planes: Dict[str, _HotPlane] = {}
        # bisect in tail_for_version needs records sorted by store_version;
        # WorkQueue appends inside the commit lock so this always holds, but
        # a raw append() with an out-of-order version flips the flag and the
        # lookups fall back to the filter scan instead of mis-bisecting
        self._monotone = True
        self._max_store_version = _VERSION_FLOOR

    def append(self, op: str, payload: Dict[str, Any],
               store_version: int = -1) -> int:
        v = self.base + len(self.records)
        rec = Txn(v, op, _freeze(payload), time.time(), store_version)
        hot = _HOT_OPS.get(op)
        if hot is not None:
            plane = self._planes.get(op)
            if plane is None:
                plane = self._planes[op] = _HotPlane(*hot)
            try:
                rec.pidx = plane.add(rec.payload)
                rec.plane = plane
            except (KeyError, AttributeError, IndexError, TypeError,
                    ValueError):
                pass        # raw append with a nonstandard payload: the
                            # record replays through the dict path instead
        self.records.append(rec)
        if store_version < self._max_store_version:
            self._monotone = False
        else:
            self._max_store_version = store_version
        return v

    # ------------------------------------------------------------ consumers
    def register_consumer(self, name: str, offset: Optional[int] = None
                          ) -> int:
        """Declare a consumer that still needs records from ``offset`` on
        (default: the current compaction base). ``truncate`` never drops a
        record any registered consumer has not acked past."""
        off = self.base if offset is None else max(int(offset), self.base)
        with self._consumers_mu:
            self._consumers[name] = off
        return off

    def ack(self, name: str, offset: int) -> bool:
        """Record that ``name`` has durably consumed everything before
        ``offset`` (absolute). Consumption only moves forward. Safe to call
        from any thread (the async checkpoint writer does). Unknown names —
        never registered, or released by ``unregister_consumer`` — are
        IGNORED (returns False): an ack must never resurrect a consumer and
        re-pin the compaction floor."""
        with self._consumers_mu:
            if name not in self._consumers:
                return False
            self._consumers[name] = max(self._consumers[name], int(offset))
            return True

    def unregister_consumer(self, name: str) -> None:
        with self._consumers_mu:
            self._consumers.pop(name, None)

    def has_consumer(self, name: str) -> bool:
        with self._consumers_mu:
            return name in self._consumers

    def consumer_floor(self) -> Optional[int]:
        """Smallest acked offset across registered consumers (None if no
        consumer is registered — then truncate without an explicit bound
        is a no-op, the conservative default). With an N-replica group
        each member is its own consumer, so this IS the min-over-group
        truncate floor: a lagging replica pins exactly its unconsumed
        prefix."""
        with self._consumers_mu:
            return min(self._consumers.values()) if self._consumers else None

    def consumer_offsets(self) -> Dict[str, int]:
        """Snapshot of every registered consumer's acked offset (copy) —
        the fabric's per-replica lag bookkeeping reads this, it never
        reaches into the map."""
        with self._consumers_mu:
            return dict(self._consumers)

    def truncate(self, upto: Optional[int] = None) -> int:
        """Drop the consumed prefix: records with absolute index below
        min(every registered consumer's acked offset[, ``upto``]).

        Advances ``base`` and ``horizon_version`` so later version-aligned
        lookups below the horizon fail loudly (LogCompactedError) instead of
        replaying an incomplete delta. With no registered consumers and no
        explicit ``upto`` this is a no-op. Returns #records dropped.
        """
        floor = self.consumer_floor()
        if upto is not None:
            floor = upto if floor is None else min(floor, int(upto))
        if floor is None or floor <= self.base:
            return 0
        drop = min(int(floor), self.base + len(self.records)) - self.base
        if drop <= 0:
            return 0
        dropped = self.records[:drop]
        self.horizon_version = max(self.horizon_version,
                                   max(r.store_version for r in dropped))
        # trim each hot plane past its last dropped entry so plane memory
        # is bounded by the same consumer floor as the record list
        plane_cut: Dict[str, int] = {}
        for r in dropped:
            if r.plane is not None:
                plane_cut[r.op] = r.pidx + 1
        for op, cut in plane_cut.items():
            self._planes[op].truncate(cut)
        del self.records[:drop]
        self.base += drop
        return drop

    # --------------------------------------------------------------- reads
    def _check_not_compacted(self, abs_index: int) -> None:
        if abs_index < self.base:
            raise LogCompactedError(
                f"log records [{abs_index}, {self.base}) were truncated; "
                f"replay from a snapshot at version >= {self.horizon_version}"
                " (the last checkpoint) instead")

    def tail(self, since: int) -> List[Txn]:
        self._check_not_compacted(since)
        return self.records[since - self.base:]

    def slice(self, lo: int, hi: int) -> List[Txn]:
        """Records with absolute index in [lo, hi)."""
        self._check_not_compacted(lo)
        return self.records[lo - self.base: max(hi, lo) - self.base]

    def _check_horizon(self, store_version: int) -> None:
        """A delta anchored strictly below the compaction horizon would be
        missing truncated records — fail loudly, never return it."""
        if store_version < self.horizon_version:
            raise LogCompactedError(
                f"delta since store version {store_version} is incomplete: "
                f"records up to version {self.horizon_version} were "
                "truncated; anchor at the last checkpoint instead")

    def index_after_version(self, store_version: int) -> int:
        """ABSOLUTE index of the first record with ``store_version`` strictly
        greater than the argument — O(log n) bisect over the monotone version
        column. Raises LogCompactedError when records at that boundary were
        truncated (the delta anchored there is no longer complete)."""
        self._check_horizon(store_version)
        if not self._monotone:
            for i, r in enumerate(self.records):
                if r.store_version > store_version:
                    return self.base + i
            return self.base + len(self.records)
        return self.base + bisect.bisect_right(
            self.records, store_version, key=lambda r: r.store_version)

    def tail_for_version(self, store_version: int) -> List[Txn]:
        """Records committed strictly after a store version (snapshot delta).

        O(log n) bisect to the start index — records are monotone in
        ``store_version`` for any log fed through the WorkQueue (appends
        happen inside the commit lock); a log made non-monotone by raw
        appends falls back to the O(n) filter scan this replaces.
        """
        if not self._monotone:
            self._check_horizon(store_version)
            return [r for r in self.records
                    if r.store_version > store_version]
        return self.records[self.index_after_version(store_version)
                            - self.base:]

    def records_between(self, after_version: int, upto_version: int
                        ) -> List[Txn]:
        """Records with ``after_version < store_version <= upto_version`` —
        the bounded delta between two snapshot versions (time travel)."""
        if not self._monotone:
            self._check_horizon(after_version)
            return [r for r in self.records
                    if after_version < r.store_version <= upto_version]
        lo = self.index_after_version(after_version)
        hi = self.index_after_version(upto_version)
        return self.records[lo - self.base: hi - self.base]

    def __len__(self) -> int:
        """Absolute end offset (total records ever appended) — unchanged by
        truncation, so lag/offset arithmetic survives compaction."""
        return self.base + len(self.records)

    @property
    def n_retained(self) -> int:
        """Records currently held in memory (what compaction bounds)."""
        return len(self.records)


def _freeze(payload: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in payload.items():
        if isinstance(v, np.ndarray):
            out[k] = np.array(v, copy=True)
        elif isinstance(v, dict):
            out[k] = {kk: (np.array(vv, copy=True)
                           if isinstance(vv, np.ndarray) else vv)
                      for kk, vv in v.items()}
        else:
            out[k] = v
    return out
