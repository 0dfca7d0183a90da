"""Zero-copy columnar wire codec for txn-log delta shipping.

The paper's replicas live on OTHER hosts: the transaction-log delta must
actually cross a NIC, and the cost of crossing it is the cost of the bytes
ON THE WIRE, not of the Python objects in memory. This codec turns a log
tail into length-prefixed frames a socket/pipe can ship:

HOT frames (claim / claim_all / finish — the ops that dominate real logs)
ship a *plane slice*: the txn log already accumulates these ops into
columnar hot planes at append time (:class:`~repro_torch.core.transactions._HotPlane`),
so a consecutive same-op run encodes as a handful of contiguous typed
buffers (row indices, per-record scalars, domain outputs) framed verbatim —
no per-record dict traversal, no pickling on the hot path. Decoding is
``np.frombuffer`` over the received buffer: the arrays alias the wire bytes
(zero-copy), and the decoded records carry a receive-side plane so
:func:`repro_torch.core.replication.replay` takes its O(1)-slice fast path on the
replica too.

COLD frames cover everything else (inserts, fails, steering, resizes, runs
whose plane entries were dropped by a ``TxnLog.truncate``): self-describing
pickled ``(op, store_version, payload)`` triples. Cold ops are rare by the
paper's op inventory (Fig. 12), so the fallback's per-record cost never
sits on the replication hot path.

Compressed hot frames (codec ``"varint"``)
------------------------------------------
The integer planes of a hot run are nearly-free to shrink before they hit
a NIC: ``store_version`` increments by ~1 per record, row indices within a
run are nearly sorted, per-record row counts are tiny, and ``now``
timestamps form near-arithmetic sequences. ``HOTC`` frames therefore ship
delta + zigzag + varint streams (first value absolute, then diffs) for
``versions``/``rows``/``worker``, plain varints for the per-record lengths
(``off`` re-derives by cumsum), and a double-delta varint of the raw IEEE
bit patterns for ``now`` (arithmetic timestamp sequences collapse to
1-byte records; arbitrary floats degrade gracefully to <= 10 bytes).
Domain outputs stay raw ``f64`` — simulation results don't varint. All
encode/decode paths are vectorized NumPy (no per-record Python), decode is
bit-exact vs the raw codec (the parity oracle, property-tested), and the
codec is negotiated PER CONNECTION in the replication hello exchange —
``raw`` stays the universal fallback.

Frame layout (all little-endian)::

    header  : magic u16 | ftype u8 | opcode u8 | n_records u32 | body u64
    HOT body: versions i64[n] | off i64[n+1] (re-based, off[0]==0)
              | rows i64[off[n]] | now f64[n]
              | claim only:  worker i32[n]
              | finish only: has_dom u8 | width u32
                             | dom f64[off[n] * width]  (has_dom == 1 only)
    HOTC body: versions dzv[n] | lens v[n] | rows dzv[off[n]]
              | now ddv[n]
              | claim only:  worker dzv[n]
              | finish only: has_dom u8 | width u32 | dom f64 (raw)
              (v = varint, dzv = delta+zigzag varint with absolute first
               value, ddv = double-delta varint of the u64 bit patterns)
    COLD body: pickle([(op, store_version, payload), ...])

``off`` is the cumulative per-record row count (n+1 entries), so a frame is
fully self-delimiting: every section length derives from the header and the
previously parsed sections. A hot finish frame is only emitted when the
run is *plane-servable* (every written row carries domain outputs, or none
does — the same condition replay's plane path checks); mixed or
width-drifted runs fall back to a cold frame, which preserves their frozen
payloads bit-exactly.
"""
from __future__ import annotations

import itertools
import pickle
import struct
import threading
from collections import OrderedDict
from operator import attrgetter
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.transactions import Txn, plane_run

MAGIC = 0x5157                       # "WQ"
FT_HOT = 1
FT_COLD = 2
FT_HOTC = 3                          # varint/delta compressed hot frame

_HDR = struct.Struct("<HBBIQ")       # magic, ftype, opcode, n_records, body
_FIN = struct.Struct("<BI")          # has_dom, dom width

_OPCODES = {"claim": 1, "claim_all": 2, "finish": 3}
_OPS = {v: k for k, v in _OPCODES.items()}

# Codec names this build can ENCODE and DECODE, in preference order. The
# replication hello exchange offers the sender's list; the receiver picks
# the first it supports (negotiate). "raw" is the universal fallback and
# the bit-parity oracle the compressed paths are tested against.
CODECS = ("adaptive", "varint", "raw")


def negotiate(offered) -> str:
    """Receiver side of the hello exchange: first offered codec we speak."""
    for c in offered:
        if c in CODECS:
            return c
    return "raw"


# ------------------------------------------------------------------ codecs
class Codec:
    """Per-connection encode policy, resolved ONCE at hello time.

    Frames self-describe their encoding (``ftype``), so the decoder needs
    no codec state — a ``Codec`` only decides, per hot frame, which
    encoding the SENDER emits. ``choose`` sees the frame's shape (op,
    record count, the exact raw body size, and how much of it is the
    incompressible f64 domain block) and returns ``"raw"`` or
    ``"varint"``. The ``"raw"``/``"varint"`` string spellings remain
    accepted everywhere via :func:`as_codec` for back-compat.
    """

    name = "?"

    def choose(self, op: str, n_records: int, raw_nbytes: int,
               dom_nbytes: int) -> str:
        raise NotImplementedError

    def __repr__(self) -> str:                        # pragma: no cover
        return f"<Codec {self.name}>"


class RawCodec(Codec):
    """Always raw: the universal fallback and bit-parity oracle."""

    name = "raw"

    def choose(self, op, n_records, raw_nbytes, dom_nbytes) -> str:
        return "raw"


class VarintCodec(Codec):
    """Always varint-compress hot frames (PR 5 behavior)."""

    name = "varint"

    def choose(self, op, n_records, raw_nbytes, dom_nbytes) -> str:
        return "varint"


class AdaptiveCodec(Codec):
    """Per-frame choice: compress only where the varint planes pay.

    * Tiny frames (< ``min_records``) ship raw — the encode setup cost
      exceeds the handful of bytes saved, and short alternating runs are
      exactly the incremental-sync shape whose throughput collapsed when
      every frame paid the varint toll.
    * Dom-heavy finish frames ship raw: domain outputs are f64 simulation
      results that do not varint, so when they are >= ``dom_cutoff`` of
      the raw body, the int-plane savings cannot reach 1 - dom_cutoff of
      the frame — not worth the encode wall.
    * Everything else (claim/claim_all runs, narrow-dom finishes — the
      ops that dominate real logs) compresses ~3-6x and ships varint.
    """

    name = "adaptive"
    min_records = 4
    dom_cutoff = 2.0 / 3.0

    def choose(self, op, n_records, raw_nbytes, dom_nbytes) -> str:
        if n_records < self.min_records:
            return "raw"
        if dom_nbytes >= self.dom_cutoff * raw_nbytes:
            return "raw"
        return "varint"


_CODECS_BY_NAME: Dict[str, Codec] = {
    "raw": RawCodec(), "varint": VarintCodec(), "adaptive": AdaptiveCodec(),
}

CodecLike = Union[str, Codec]


def as_codec(codec: CodecLike) -> Codec:
    """Resolve a codec spelling (``"raw"``/``"varint"``/``"adaptive"`` or a
    :class:`Codec` instance) to the object the encode paths consume."""
    if isinstance(codec, Codec):
        return codec
    try:
        return _CODECS_BY_NAME[codec]
    except (KeyError, TypeError):
        raise ValueError(f"unknown wire codec {codec!r}") from None


class WireError(ValueError):
    """Malformed or truncated wire frame."""


# -------------------------------------------------------- varint primitives
# All vectorized: the per-record Python toll is exactly what the hot-frame
# path exists to avoid. Values are u64; signed streams go through zigzag
# first. Encoded length is <= 10 bytes/value, 1 byte for values < 128 —
# which deltas of nearly-sorted planes almost always are.
def _zigzag(v: np.ndarray) -> np.ndarray:
    """int64 -> uint64, small magnitudes (either sign) -> small codes."""
    v = np.ascontiguousarray(v, np.int64)
    return (v.astype(np.uint64) << np.uint64(1)) \
        ^ (v >> np.int64(63)).astype(np.uint64)


def _unzigzag(u: np.ndarray) -> np.ndarray:
    u = np.ascontiguousarray(u, np.uint64)
    return ((u >> np.uint64(1))
            ^ (np.uint64(0) - (u & np.uint64(1)))).view(np.int64)


def _varint_encode(u: np.ndarray) -> np.ndarray:
    """LEB128-style encode of a u64 vector -> one uint8 stream."""
    n = u.size
    if n == 0:
        return np.empty(0, np.uint8)
    u = np.ascontiguousarray(u, np.uint64)
    if int(u.max()) < 128:
        # the dominant section shape: every delta fits one byte (unit row/
        # version steps, tiny lens) — skip the whole length machinery
        return u.astype(np.uint8)
    nb = np.ones(n, np.int64)                   # bytes per value
    tmp = u >> np.uint64(7)
    while tmp.any():
        nb += tmp != 0
        tmp >>= np.uint64(7)
    ends = np.cumsum(nb)
    out = np.empty(int(ends[-1]), np.uint8)
    pos = ends - nb
    rem = u.copy()
    alive = np.arange(n)
    while alive.size:
        chunk = rem[alive]
        more = (chunk >> np.uint64(7)) != 0
        out[pos[alive]] = (chunk & np.uint64(0x7F)).astype(np.uint8) \
            | (more.astype(np.uint8) << 7)
        rem[alive] >>= np.uint64(7)
        pos[alive] += 1
        alive = alive[more]
    return out


def _varint_decode(body: np.ndarray, count: int, cur: int):
    """Decode ``count`` varints from ``body`` (uint8) starting at ``cur``.
    Returns (uint64 values, cursor after the last consumed byte)."""
    if count == 0:
        return np.empty(0, np.uint64), cur
    # a u64 varint is <= 10 bytes, so the section lives entirely within
    # the next 10*count bytes — bounding the terminator scan keeps decode
    # O(section), not O(sections x frame) (the raw f64 dom block trailing
    # a finish frame would otherwise be re-scanned once per section)
    b = body[cur: cur + 10 * count]
    term = np.nonzero(b < 0x80)[0]
    if term.size < count:
        raise WireError("truncated varint section")
    ends = term[:count]
    starts = np.empty(count, np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1
    max_len = int(lens.max())
    if max_len > 10:
        raise WireError(f"varint of {max_len} bytes exceeds u64")
    vals = np.zeros(count, np.uint64)
    for j in range(max_len):
        sel = lens > j
        vals[sel] |= (b[starts[sel] + j].astype(np.uint64)
                      & np.uint64(0x7F)) << np.uint64(7 * j)
    return vals, cur + int(ends[-1]) + 1


def _enc_delta_i64(vals: np.ndarray) -> np.ndarray:
    """delta + zigzag + varint of an i64 vector (first value absolute)."""
    vals = np.ascontiguousarray(vals, np.int64)
    if vals.size == 0:
        return np.empty(0, np.uint8)
    d = np.empty(vals.size, np.int64)
    d[0] = vals[0]
    np.subtract(vals[1:], vals[:-1], out=d[1:])
    return _varint_encode(_zigzag(d))


def _dec_delta_i64(body: np.ndarray, count: int, cur: int):
    u, cur = _varint_decode(body, count, cur)
    return np.cumsum(_unzigzag(u), dtype=np.int64), cur


def _enc_f64_dd(vals: np.ndarray) -> np.ndarray:
    """Double-delta varint of the raw u64 bit patterns of an f64 vector.

    Near-arithmetic timestamp sequences have near-constant bit-pattern
    first differences within a binade, so the second difference is ~0 and
    each record costs ~1 byte; the stream is exact for ANY floats (bit
    patterns round-trip, NaN payloads included) — just not always small.
    Layout: varint(bits[0]) | zz(d[0]) | zz(dd...), diffs modular in u64.
    """
    bits = np.ascontiguousarray(vals, np.float64).view(np.uint64)
    n = bits.size
    if n == 0:
        return np.empty(0, np.uint8)
    stream = np.empty(n, np.uint64)
    stream[0] = bits[0]
    if n > 1:
        d = np.diff(bits)                       # modular u64
        stream[1] = _zigzag(d[:1].view(np.int64))[0]
        if n > 2:
            stream[2:] = _zigzag(np.diff(d).view(np.int64))
    return _varint_encode(stream)


def _dec_f64_dd(body: np.ndarray, count: int, cur: int):
    u, cur = _varint_decode(body, count, cur)
    if count == 0:
        return np.empty(0, np.float64), cur
    bits = np.empty(count, np.uint64)
    bits[0] = u[0]
    if count > 1:
        dd = np.ascontiguousarray(_unzigzag(u[1:])).view(np.uint64)
        d = np.cumsum(dd, dtype=np.uint64)      # [d0, dd...] -> first diffs
        bits[1:] = bits[0] + np.cumsum(d, dtype=np.uint64)
    return bits.view(np.float64), cur


def _mv(arr: np.ndarray):
    """Byte view of a contiguous array — what the frame ships verbatim.
    (Zero-size arrays — e.g. a width-0 domain block — have no castable
    buffer; they contribute zero bytes.)"""
    if arr.size == 0:
        return b""
    return memoryview(np.ascontiguousarray(arr)).cast("B")


def _dom_servable(fields: Dict[str, Any], n_rows: int) -> Optional[bool]:
    """Whether a finish run's dom sub-update is wire-servable as one block.

    Returns True (every row carries dom), False (no row does), or None —
    mixed / width-drifted runs that must ship as a cold frame (mirrors the
    conditions of the replay plane path).
    """
    doff = fields["dom_off"]
    d0, d1 = int(doff[0]), int(doff[-1])
    if d1 > d0:
        return True if d1 - d0 == n_rows else None
    return None if int(fields["dom_flag"].sum()) else False


# ------------------------------------------------------------------ encode
def _hot_frame_fields(op: str, recs: Sequence[Txn], f: Dict[str, Any],
                      codec: Codec) -> Optional[List[Any]]:
    """Frame chunks for one hot run from ALREADY-CAPTURED plane fields.

    ``f`` is a ``slice_fields`` capture: the pipelined shipper stages it on
    the producer thread (same thread as plane compaction, so the capture
    is race-free) and encodes HERE from the staged views on its own thread
    — compaction re-bases into fresh buffers, so the old views stay
    frozen. Returns None when the run's dom sub-update is not servable
    (ships cold instead).
    """
    n = len(recs)
    off = f["off"].astype(np.int64)          # re-based copy: off[0] == 0
    off -= off[0]
    n_rows = int(off[-1])
    # dom servability + size first: it gates the frame entirely, and the
    # per-frame codec choice needs to see the incompressible dom fraction
    dom = None
    if op == "finish":
        servable = _dom_servable(f, n_rows)
        if servable is None:
            return None
        if servable:
            dom = f["dom"]
    dom_nbytes = 8 * n_rows * dom.shape[1] if dom is not None else 0
    raw_nbytes = 8 * n + 8 * (n + 1) + 8 * n_rows + 8 * n \
        + (4 * n if op == "claim" else 0) \
        + (_FIN.size + dom_nbytes if op == "finish" else 0)
    enc = codec.choose(op, n, raw_nbytes, dom_nbytes)
    versions = np.fromiter(map(attrgetter("store_version"), recs),
                           np.int64, n)
    if enc == "varint":
        chunks: List[Any] = [
            None,                            # header patched in below
            _mv(_enc_delta_i64(versions)),
            _mv(_varint_encode(np.diff(off).astype(np.uint64))),
            _mv(_enc_delta_i64(f["rows"])),
            _mv(_enc_f64_dd(f["now"])),
        ]
        if op == "claim":
            chunks.append(_mv(_enc_delta_i64(f["worker"])))
    elif enc == "raw":
        chunks = [
            None,
            _mv(versions),
            _mv(off),
            _mv(f["rows"]),
            _mv(f["now"]),
        ]
        if op == "claim":
            chunks.append(_mv(f["worker"]))
    else:
        raise ValueError(f"codec {codec.name!r} chose unknown "
                         f"encoding {enc!r}")
    if op == "finish":
        if dom is not None:
            chunks.append(_FIN.pack(1, dom.shape[1]))
            chunks.append(_mv(dom))          # sim outputs don't varint
        else:
            chunks.append(_FIN.pack(0, 0))
    body = sum(len(c) for c in chunks[1:])
    chunks[0] = _HDR.pack(MAGIC, FT_HOT if enc == "raw" else FT_HOTC,
                          _OPCODES[op], n, body)
    return chunks


def _hot_frame(op: str, recs: Sequence[Txn],
               codec: CodecLike = "raw") -> Optional[List[Any]]:
    """Frame chunks for one plane-contiguous hot run, or None when the run
    cannot be served off its plane (then it ships as a cold frame)."""
    sl = plane_run(recs)
    if sl is None:
        return None
    plane, lo, hi = sl
    return _hot_frame_fields(op, recs, plane.slice_fields(lo, hi),
                             as_codec(codec))


def _cold_frame(recs: Sequence[Txn]) -> List[Any]:
    blob = pickle.dumps(
        [(r.op, r.store_version, r.payload) for r in recs],
        protocol=pickle.HIGHEST_PROTOCOL)
    return [_HDR.pack(MAGIC, FT_COLD, 0, len(recs), len(blob)), blob]


def iter_frames(records: Iterable[Txn],
                codec: CodecLike = "raw") -> Iterable[List[Any]]:
    """Frames (each a list of bytes-like chunks) for a log delta, one frame
    per consecutive same-op run — the unit :func:`replay` coalesces."""
    codec = as_codec(codec)
    for op, run in itertools.groupby(records, key=attrgetter("op")):
        recs = list(run)
        frame = _hot_frame(op, recs, codec) if op in _OPCODES else None
        yield frame if frame is not None else _cold_frame(recs)


def delta_to_bytes(records: Iterable[Txn], codec: CodecLike = "raw") -> bytes:
    """One contiguous buffer holding every frame of the delta — what a
    ``send_bytes`` ships (a writev-style transport can send ``iter_frames``
    chunks without this join)."""
    return b"".join(c for frame in iter_frames(records, codec)
                    for c in frame)


def frames_nbytes(records: Iterable[Txn], codec: CodecLike = "raw") -> int:
    """Exact encoded wire size of a delta: ``len(delta_to_bytes(records))``.

    The raw codec is sized analytically without materializing the hot
    buffers (cold runs must still pickle — their size is not knowable
    otherwise; they are rare by construction). Varint sections only know
    their size by encoding, so other codecs sum real frames.
    """
    codec = as_codec(codec)
    if codec.name != "raw":
        return sum(len(c) for frame in iter_frames(records, codec)
                   for c in frame)
    total = 0
    for op, run in itertools.groupby(records, key=attrgetter("op")):
        recs = list(run)
        n = len(recs)
        sl = plane_run(recs) if op in _OPCODES else None
        if sl is not None:
            plane, lo, hi = sl
            f = plane.slice_fields(lo, hi)
            n_rows = int(f["off"][-1] - f["off"][0])
            servable = _dom_servable(f, n_rows) if op == "finish" else False
            if op != "finish" or servable is not None:
                total += _HDR.size + 8 * n + 8 * (n + 1) + 8 * n_rows + 8 * n
                if op == "claim":
                    total += 4 * n
                elif op == "finish":
                    total += _FIN.size
                    if servable:
                        total += 8 * n_rows * f["dom"].shape[1]
                continue
        total += _HDR.size + len(pickle.dumps(
            [(r.op, r.store_version, r.payload) for r in recs],
            protocol=pickle.HIGHEST_PROTOCOL))
    return total


def frames_nbytes_detail(records: Iterable[Txn],
                         codec: CodecLike = "raw") -> Dict[str, int]:
    """Encoded size split into hot and cold frame bytes.

    Cold frames are byte-identical across codecs (pickles don't
    re-encode), so ``hot`` is the comparable base for compression ratios:
    ``frames_nbytes_detail(recs, "raw")["hot"] /
    frames_nbytes_detail(recs, "varint")["hot"]`` is what the varint codec
    saves on the planes it actually touches.
    """
    hot = cold = 0
    for frame in iter_frames(records, codec):
        size = sum(len(c) for c in frame)
        if frame[0][2] == FT_COLD:            # header byte 2 is ftype
            cold += size
        else:
            hot += size
    return {"total": hot + cold, "hot": hot, "cold": cold}


# ----------------------------------------------------------------- staging
# The pipelined shipper's producer/consumer split of the encode path:
# stage_delta runs on the PRODUCER thread (the only thread allowed to
# touch the log's planes — TxnLog's threading contract) and captures, per
# same-op run, the plane views the frame will encode from; encode_staged
# runs later on the shipper thread against those frozen captures only.
# Compaction between the two is safe by construction: _GrowBuf.trim_front
# re-bases into FRESH buffers, so a staged view keeps aliasing the old
# (immutable) allocation, and appends only ever write past the captured
# range (growth reallocates).
class StagedRun:
    """One same-op run of a staged chunk: records plus their plane capture
    (``fields`` is None for cold runs — they encode from frozen payloads,
    which are immutable and thread-safe by construction)."""

    __slots__ = ("op", "recs", "fields")

    def __init__(self, op: str, recs: Sequence[Txn],
                 fields: Optional[Dict[str, Any]]):
        self.op = op
        self.recs = recs
        self.fields = fields


class StagedChunk:
    """A contiguous span [lo, hi) of log records captured for deferred
    encoding. Chunks are the shipper's queue items AND its encode units:
    bounded size keeps encode/ship overlapped (chunk i+1 encodes while the
    remote still replays chunk i) and bounds staged-view memory."""

    __slots__ = ("lo", "hi", "runs")

    def __init__(self, lo: int, hi: int, runs: List[StagedRun]):
        self.lo = lo
        self.hi = hi
        self.runs = runs

    @property
    def n_records(self) -> int:
        return self.hi - self.lo


def stage_delta(records: Sequence[Txn], lo: int,
                chunk_records: int = 2048) -> List[StagedChunk]:
    """Split a log tail starting at absolute offset ``lo`` into staged
    chunks of <= ``chunk_records`` records each, capturing every hot run's
    plane views NOW (producer thread). Splitting a long run across chunks
    is legal — each sub-run is still plane-contiguous and decodes to the
    same replay — and is exactly what lets encode overlap shipping."""
    out: List[StagedChunk] = []
    for start in range(0, len(records), max(chunk_records, 1)):
        sub = records[start: start + chunk_records]
        runs: List[StagedRun] = []
        for op, run in itertools.groupby(sub, key=attrgetter("op")):
            recs = list(run)
            fields = None
            if op in _OPCODES:
                sl = plane_run(recs)
                if sl is not None:
                    plane, plo, phi = sl
                    fields = plane.slice_fields(plo, phi)
            runs.append(StagedRun(op, recs, fields))
        out.append(StagedChunk(lo + start, lo + start + len(sub), runs))
    return out


# Exact per-record payload_nbytes() totals for the hot-op payload layouts
# (claim: worker/rows/now/ids, claim_all: n/rows/now, finish: ids/rows/now
# + optional domain_out): fixed charge per record + 8 bytes per i64 row
# entry. Lets replicator ack accounting stay O(runs), not O(records).
_PAYLOAD_FIXED = {"claim": 16, "claim_all": 16, "finish": 8}
_PAYLOAD_PER_ROW = {"claim": 16, "claim_all": 8, "finish": 16}


def staged_payload_nbytes(run: StagedRun) -> int:
    """Sum of ``payload_nbytes()`` over the run's records — computed from
    the captured plane fields in O(1) for hot runs (bit-exact vs the
    per-record sum, property-tested), per-record fallback otherwise.

    Finish runs take the fast path only when ``_dom_servable`` decides
    the capture represents the payloads exactly (every row's domain block
    captured, or none at all): mixed and width-drifted runs keep their
    ``domain_out`` only in the record payloads, so they cannot be sized
    from the capture alone — same rule as hot-frame eligibility.
    """
    f = run.fields
    fixed = _PAYLOAD_FIXED.get(run.op)
    if f is None or fixed is None:
        return sum(r.payload_nbytes() for r in run.recs)
    off = f["off"]
    n_rows = int(off[-1]) - int(off[0])
    dom_nbytes = 0
    if run.op == "finish":
        servable = _dom_servable(f, n_rows)
        if servable is None:
            return sum(r.payload_nbytes() for r in run.recs)
        if servable:
            dom_nbytes = f["dom"].nbytes
    return fixed * len(run.recs) + _PAYLOAD_PER_ROW[run.op] * n_rows \
        + dom_nbytes


def encode_staged(chunk: StagedChunk, codec: CodecLike) -> bytes:
    """Encode one staged chunk into its frame buffer — safe on any thread
    (touches only the chunk's frozen captures, never the live planes)."""
    codec = as_codec(codec)
    parts: List[Any] = []
    for r in chunk.runs:
        frame = None
        if r.fields is not None:
            frame = _hot_frame_fields(r.op, r.recs, r.fields, codec)
        if frame is None:
            frame = _cold_frame(r.recs)
        parts.extend(frame)
    return b"".join(parts)


class DeltaEncoder:
    """Encode-once cache for broadcast fan-out.

    A :class:`~repro_torch.core.replication.ReplicaGroup` ships the SAME log
    span to every member; pre-PR 6 each member re-encoded it. Members now
    share one encoder: the first caller for a ``(lo, hi, codec)`` span
    pays the encode, concurrent and later callers get the identical bytes
    back (``hits``). Entries are LRU-bounded — the broadcast consumes an
    entry within one sync, so a handful of chunks of history suffices.

    Thread-safe: concurrent requests for the same key block on the owning
    encoder's completion instead of duplicating work; if the owner fails,
    waiters fall back to encoding themselves.
    """

    def __init__(self, max_entries: int = 32):
        self._mu = threading.Lock()
        self._entries: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._inflight: Dict[tuple, threading.Event] = {}
        self.max_entries = max_entries
        self.encodes = 0
        self.hits = 0

    def _get_or_encode(self, key, thunk) -> bytes:
        while True:
            with self._mu:
                buf = self._entries.get(key)
                if buf is not None:
                    self.hits += 1
                    self._entries.move_to_end(key)
                    return buf
                ev = self._inflight.get(key)
                if ev is None:
                    ev = self._inflight[key] = threading.Event()
                    break                     # we own the encode
            ev.wait(timeout=120.0)            # another thread is encoding
            with self._mu:
                buf = self._entries.get(key)
                if buf is not None:
                    self.hits += 1
                    return buf
                if key not in self._inflight:
                    # owner failed and cleared the slot without publishing:
                    # loop back and claim the encode ourselves
                    continue
        try:
            buf = thunk()
            with self._mu:
                self._entries[key] = buf
                self.encodes += 1
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
            return buf
        finally:
            with self._mu:
                self._inflight.pop(key, None)
            ev.set()

    def encode_staged(self, chunk: StagedChunk, codec: CodecLike) -> bytes:
        codec = as_codec(codec)
        return self._get_or_encode(
            (chunk.lo, chunk.hi, codec.name),
            lambda: encode_staged(chunk, codec))

    def encode_records(self, lo: int, hi: int, records: Sequence[Txn],
                       codec: CodecLike) -> bytes:
        """Synchronous-path entry: same cache key space as staged chunks
        (identical span + codec => identical bytes), so pipelined and
        synchronous members of one group still share encodes."""
        codec = as_codec(codec)
        return self._get_or_encode(
            (lo, hi, codec.name),
            lambda: delta_to_bytes(records, codec))

    def stats(self) -> Dict[str, int]:
        return {"encodes": self.encodes, "hits": self.hits,
                "entries": len(self._entries)}


# ------------------------------------------------------------------ decode
class _RxField:
    """Receive-side buffer with the ``.view(lo, hi)`` surface the replay
    plane path slices — backed directly by the wire bytes (zero-copy)."""

    __slots__ = ("data",)

    def __init__(self, data: np.ndarray):
        self.data = data

    def view(self, lo: int, hi: int) -> np.ndarray:
        return self.data[lo:hi]


class _RxPlane:
    """Decoded hot frame, shaped like the sender's ``_HotPlane`` slice so
    ``replay`` serves the run as O(1) views of the received buffer."""

    __slots__ = ("base", "n", "off", "rows", "now", "worker",
                 "dom_off", "dom", "dom_flag")

    def __init__(self, n: int, off, rows, now, worker=None,
                 dom=None, has_dom: bool = False):
        self.base = 0
        self.n = n
        self.off = _RxField(off)
        self.rows = _RxField(rows)
        self.now = _RxField(now)
        self.worker = _RxField(worker) if worker is not None else None
        # reconstructed dom locator: a servable finish frame has dom rows
        # exactly aligned with its written rows (dom_off == off, every flag
        # set) or none at all — the only two shapes hot frames ship
        self.dom_off = _RxField(off if has_dom
                                else np.zeros(n + 1, np.int64))
        self.dom = _RxField(dom) if dom is not None else None
        self.dom_flag = _RxField(
            np.ones(n, np.int8) if has_dom else np.zeros(n, np.int8))

    def record_payload(self, i: int, op: str) -> Dict[str, Any]:
        """Materialize one record's payload dict (replay's single-record and
        dict-batch fallbacks need it; plane-path runs never call this)."""
        lo, hi = int(self.off.data[i]), int(self.off.data[i + 1])
        p: Dict[str, Any] = {"rows": self.rows.data[lo:hi],
                             "now": float(self.now.data[i])}
        if self.worker is not None:
            p["worker"] = int(self.worker.data[i])
        if op == "finish" and self.dom is not None:
            p["domain_out"] = self.dom.data[lo:hi]
        return p


class WireTxn:
    """Decoded log record: replayable via :func:`repro_torch.core.replication.replay`
    (op/store_version/plane/pidx drive the plane fast path; ``payload``
    materializes lazily from the received buffers when a fallback needs it)."""

    __slots__ = ("op", "store_version", "plane", "pidx", "_payload")

    def __init__(self, op: str, store_version: int, plane: Optional[_RxPlane],
                 pidx: int, payload: Optional[Dict[str, Any]] = None):
        self.op = op
        self.store_version = store_version
        self.plane = plane
        self.pidx = pidx
        self._payload = payload

    @property
    def payload(self) -> Dict[str, Any]:
        if self._payload is None:
            self._payload = self.plane.record_payload(self.pidx, self.op)
        return self._payload

    def __repr__(self) -> str:                        # pragma: no cover
        return f"WireTxn({self.op!r}, v={self.store_version})"


class DecodedRun:
    """One decoded frame as a run-level replay unit.

    Hot frames carry their receive plane plus the per-record version
    column — NO per-record objects (materializing one ``WireTxn`` per
    record is the dominant decode cost on large frames, and batched
    replay only ever looks at the run's endpoints). Cold frames keep
    their per-record ``WireTxn`` list (``recs``), mixed ops included.
    """

    __slots__ = ("op", "plane", "versions", "recs")

    def __init__(self, op: Optional[str], plane: Optional[_RxPlane],
                 versions: Optional[np.ndarray],
                 recs: Optional[List[WireTxn]] = None):
        self.op = op
        self.plane = plane
        self.versions = versions
        self.recs = recs

    @property
    def n(self) -> int:
        return len(self.recs) if self.recs is not None \
            else int(self.versions.size)

    @property
    def last_version(self) -> int:
        return int(self.versions[-1])

    def materialize(self) -> List[WireTxn]:
        """Per-record view of the run — the replay fallback paths (and
        :func:`decode_delta`) still speak records."""
        if self.recs is not None:
            return self.recs
        return list(map(WireTxn, itertools.repeat(self.op),
                        self.versions.tolist(),
                        itertools.repeat(self.plane), range(self.n)))


def _parse_frames(buf) -> List[DecodedRun]:
    """Parse a frame buffer into run-level decode units, in log order.

    Hot frames decode as ``np.frombuffer`` views of ``buf`` — no copies of
    the row/scalar/domain sections; cold frames unpickle their payloads.
    """
    out: List[DecodedRun] = []
    pos, end_all = 0, len(buf)
    while pos < end_all:
        if pos + _HDR.size > end_all:
            raise WireError("truncated frame header")
        magic, ftype, opcode, n, body = _HDR.unpack_from(buf, pos)
        if magic != MAGIC:
            raise WireError(f"bad frame magic {magic:#x} at offset {pos}")
        pos += _HDR.size
        end = pos + body
        if end > end_all:
            raise WireError("truncated frame body")
        if ftype == FT_COLD:
            out.append(DecodedRun(None, None, None, [
                WireTxn(op, sv, None, -1, payload)
                for op, sv, payload in pickle.loads(buf[pos:end])]))
        elif ftype == FT_HOTC:
            op = _OPS.get(opcode)
            if op is None:
                raise WireError(f"unknown hot opcode {opcode}")
            body_u8 = np.frombuffer(buf, np.uint8, body, pos)
            cur = 0
            versions, cur = _dec_delta_i64(body_u8, n, cur)
            lens, cur = _varint_decode(body_u8, n, cur)
            off = np.zeros(n + 1, np.int64)
            np.cumsum(lens.astype(np.int64), out=off[1:])
            n_rows = int(off[-1])
            rows, cur = _dec_delta_i64(body_u8, n_rows, cur)
            now, cur = _dec_f64_dd(body_u8, n, cur)
            worker = dom = None
            has_dom = False
            if op == "claim":
                w64, cur = _dec_delta_i64(body_u8, n, cur)
                worker = w64.astype(np.int32)
            elif op == "finish":
                flag, width = _FIN.unpack_from(buf, pos + cur)
                cur += _FIN.size
                has_dom = bool(flag)
                if has_dom:
                    dom = np.frombuffer(
                        buf, np.float64, n_rows * width, pos + cur
                    ).reshape(n_rows, width) if width else \
                        np.empty((n_rows, 0), np.float64)
                    cur += 8 * n_rows * width
            if cur != body:
                raise WireError(
                    f"compressed hot frame body mismatch: "
                    f"parsed {cur} != {body}")
            plane = _RxPlane(n, off, rows, now, worker, dom, has_dom)
            out.append(DecodedRun(op, plane, versions))
        elif ftype == FT_HOT:
            op = _OPS.get(opcode)
            if op is None:
                raise WireError(f"unknown hot opcode {opcode}")
            versions = np.frombuffer(buf, np.int64, n, pos)
            pos += 8 * n
            off = np.frombuffer(buf, np.int64, n + 1, pos)
            pos += 8 * (n + 1)
            n_rows = int(off[-1])
            rows = np.frombuffer(buf, np.int64, n_rows, pos)
            pos += 8 * n_rows
            now = np.frombuffer(buf, np.float64, n, pos)
            pos += 8 * n
            worker = dom = None
            has_dom = False
            if op == "claim":
                worker = np.frombuffer(buf, np.int32, n, pos)
                pos += 4 * n
            elif op == "finish":
                flag, width = _FIN.unpack_from(buf, pos)
                pos += _FIN.size
                has_dom = bool(flag)
                if has_dom:
                    # width 0 is legal (a domain_out with no columns):
                    # frombuffer of zero elements cannot infer the row
                    # count, so shape it explicitly
                    dom = np.frombuffer(
                        buf, np.float64, n_rows * width, pos
                    ).reshape(n_rows, width) if width else \
                        np.empty((n_rows, 0), np.float64)
                    pos += 8 * n_rows * width
            if pos != end:
                # the parsed sections must consume the body EXACTLY: a
                # mismatch means n_records/off disagree with the header,
                # and frombuffer would have read misaligned garbage
                raise WireError(
                    f"hot frame body mismatch: parsed {pos} != {end}")
            plane = _RxPlane(n, off, rows, now, worker, dom, has_dom)
            out.append(DecodedRun(op, plane, versions))
        else:
            raise WireError(f"unknown frame type {ftype}")
        pos = end
    return out


def decode_delta_runs(buf) -> List[DecodedRun]:
    """Run-level decode — the replica child's fast path: one
    :class:`DecodedRun` per frame, records materialized only where a
    fallback needs them (see ``repro_torch.core.replication.replay_runs``)."""
    return _parse_frames(buf)


def decode_delta(buf) -> List[WireTxn]:
    """Parse a frame buffer back into replayable records, in log order
    (the record-level surface ``replay``/tests consume)."""
    out: List[WireTxn] = []
    for run in _parse_frames(buf):
        out.extend(run.recs if run.recs is not None else run.materialize())
    return out


# ---------------------------------------------------------------------------
# Sweep-partial codec (PR 10): ship per-shard steering partials, not views
# ---------------------------------------------------------------------------
#
# The remote steering op (`G` request in repro_torch.core.replication) runs
# `steering.sweep_partials` INSIDE the replica process and ships back only
# the partial aggregates — bincount slabs, a few scalars, and compact
# ancestry columns — instead of a whole snapshot or a pickled result dict.
# Layout: `u32 header_len | pickle((meta, descs)) | raw array bytes...`
# where `meta` holds the scalar fields and `descs` is a list of
# `(key, dtype_str, shape)` for each ndarray field, whose C-contiguous
# bytes follow in order. Decode is `np.frombuffer` over the received
# buffer — the arrays alias the wire bytes (zero-copy), same discipline as
# the hot-frame codec above. The merge (`sharding_router.merge_partials`)
# only reads the arrays, so aliasing read-only wire memory is safe.

_PARTIAL_HDR = struct.Struct("<I")


def encode_sweep_partial(partial: Dict[str, Any]) -> bytes:
    """Serialize a `steering.sweep_partials` dict into one wire buffer."""
    meta: Dict[str, Any] = {}
    descs: List[Any] = []
    chunks: List[bytes] = []
    for key, val in partial.items():
        if isinstance(val, np.ndarray):
            arr = np.ascontiguousarray(val)
            descs.append((key, arr.dtype.str, arr.shape))
            chunks.append(arr.tobytes())
        else:
            meta[key] = val
    head = pickle.dumps((meta, descs), protocol=pickle.HIGHEST_PROTOCOL)
    return b"".join([_PARTIAL_HDR.pack(len(head)), head] + chunks)


def decode_sweep_partial(buf) -> Dict[str, Any]:
    """Inverse of :func:`encode_sweep_partial`; arrays alias ``buf``."""
    mv = memoryview(buf)
    (head_len,) = _PARTIAL_HDR.unpack_from(mv, 0)
    pos = _PARTIAL_HDR.size
    meta, descs = pickle.loads(mv[pos:pos + head_len])
    pos += head_len
    out: Dict[str, Any] = dict(meta)
    for key, dtype_str, shape in descs:
        dt = np.dtype(dtype_str)
        n = int(np.prod(shape)) if shape else 1
        nbytes = dt.itemsize * n
        out[key] = np.frombuffer(mv, dtype=dt, count=n,
                                 offset=pos).reshape(shape)
        pos += nbytes
    if pos != len(mv):
        raise WireError(
            f"sweep partial body mismatch: parsed {pos} != {len(mv)}")
    return out
