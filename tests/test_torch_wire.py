"""The port's wire codec (``repro_torch.core.wire``) against the
reference's (``tests/test_wire.py``): one numpy-seeded operation script
runs through both packages' work queues, and their log tails encode to
byte-identical HOT and HOTC frames in every codec; COLD frames (pickled
``(op, version, payload)`` triples, whose class paths name their package)
are equal once decoded. Each package decodes and replays the other's bytes
into the same columns, and the port's shipped replica, a spawned process,
stays bit-identical to the reference's primary across a truncate, a kill
and a promote."""
import json
import os
import struct

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import replication as ref_replication  # noqa: E402
from repro.core import steering as ref_steering  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402
from repro_torch.core import replication, steering, wire  # noqa: E402
from repro_torch.core.store import ColumnStore  # noqa: E402

CODECS = ["raw", "varint", "adaptive"]


def make_wq(pkg, workers):
    if pkg is T:
        return T.WorkQueue(num_workers=workers, device="cpu")
    return R.WorkQueue(num_workers=workers)


def mixed_workload(wq, steer, rng, rounds=10, widths=(3, 2, 0)):
    """Every op kind: claims, finishes with mixed domain widths (none,
    zero-width, drifting), fails, a requeue, a steering patch and prune,
    a resize."""
    for r in range(rounds):
        out = wq.claim_all(k=int(rng.integers(1, 3)), now=float(r))
        got = [v for v in out.values() if len(v)]
        rows = np.concatenate(got) if got else np.empty(0, np.int64)
        if len(rows) == 0:
            break
        if r % 4 == 2 and len(rows) > 1:
            wq.fail(rows[:1], now=float(r) + 0.1)
            rows = rows[1:]
        if r == 3:
            victim = wq.num_workers - 1
            wid = wq.store.col("worker_id")[rows]
            wq.requeue_worker(victim)
            rows = rows[wid != victim]
        for ch in np.array_split(rows, min(3, max(len(rows), 1))):
            if not len(ch):
                continue
            if rng.integers(0, 4) == 0:
                wq.finish(ch, now=float(r) + 0.5)
            else:
                w = int(widths[int(rng.integers(0, len(widths)))])
                wq.finish(ch, now=float(r) + 0.5,
                          domain_out=rng.normal(0.5, 0.3, (len(ch), w)))
        if r == 4:
            steer.q8_patch_ready(0, "in0", 7.0, predicate=lambda v: v > 0.5)
        if r == 5:
            wq.add_tasks(0, 3, domain_in=np.full((3, 3), 0.05),
                         now=float(r))
            steer.prune("in1", 0.0, 0.1)
        if r == 6 and wq.num_workers > 2:
            wq.resize(wq.num_workers - 1)


def scripted(pkg, seed, workers=4, n=48, rounds=10):
    """The operation script on ``pkg``'s queue (same seed: same ops)."""
    rng = np.random.default_rng(seed)
    wq = make_wq(pkg, workers)
    wq.add_tasks(0, n, domain_in=rng.uniform(0, 1, (n, 3)))
    mixed_workload(wq, pkg.SteeringEngine(wq), rng, rounds=rounds)
    return wq


def assert_cols_equal(a, b, names):
    for name in names:
        assert np.array_equal(a.col(name), b.col(name), equal_nan=True), name


def plain(payload):
    """A decoded payload as plain python (enums as ints, arrays as lists),
    so that the two packages' records compare."""
    if isinstance(payload, dict):
        return {k: plain(v) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return [plain(v) for v in payload]
    if isinstance(payload, np.ndarray):
        return payload.tolist()
    if isinstance(payload, np.generic) or hasattr(payload, "value"):
        return int(payload) if hasattr(payload, "value") else payload.item()
    return payload


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("seed", [0, 1])
def test_hot_frames_byte_identical_cold_frames_equal_decoded(codec, seed):
    ref, port = scripted(R, seed), scripted(T, seed)
    rrecs, precs = ref.log.tail(0), port.log.tail(0)
    assert [(r.op, r.store_version) for r in rrecs] \
        == [(r.op, r.store_version) for r in precs]
    rframes = [b"".join(bytes(c) for c in f)
               for f in ref_wire.iter_frames(rrecs, codec)]
    pframes = [b"".join(bytes(c) for c in f)
               for f in wire.iter_frames(precs, codec)]
    assert len(rframes) == len(pframes)
    kinds = set()
    for rb, pb in zip(rframes, pframes):
        kind = struct.unpack_from("<HBBIQ", rb)[1]
        kinds.add(kind)
        assert struct.unpack_from("<HBBIQ", pb)[1] == kind
        if kind in (wire.FT_HOT, wire.FT_HOTC):
            assert pb == rb
        else:
            got = [(d.op, d.store_version, plain(d.payload))
                   for d in wire.decode_delta(pb)]
            want = [(d.op, d.store_version, plain(d.payload))
                    for d in ref_wire.decode_delta(rb)]
            assert got == want
    assert wire.FT_COLD in kinds
    hot = {"raw": {wire.FT_HOT}, "varint": {wire.FT_HOTC},
           "adaptive": {wire.FT_HOT, wire.FT_HOTC}}[codec]
    assert kinds & hot
    assert wire.frames_nbytes_detail(precs, codec) \
        == ref_wire.frames_nbytes_detail(rrecs, codec)


@pytest.mark.parametrize("codec", ["raw", "varint"])
def test_each_package_replays_the_others_bytes(codec):
    ref, port = scripted(R, 2), scripted(T, 2)
    names = list(port.store.cols)
    rbuf = ref_wire.delta_to_bytes(ref.log.tail(0), codec)
    pbuf = wire.delta_to_bytes(port.log.tail(0), codec)
    into_port = ColumnStore(port.store.schema, capacity=256)
    replication.replay(into_port, wire.decode_delta(rbuf))
    into_ref = R.ColumnStore(ref.store.schema, capacity=256)
    ref_replication.replay(into_ref, ref_wire.decode_delta(pbuf))
    assert_cols_equal(into_port, ref.store, names)
    assert_cols_equal(into_ref, port.store, names)
    assert into_port.version == into_ref.version == ref.store.version


def test_truncate_straddling_records_ship_cold_as_the_reference():
    def run(pkg, w):
        wq = make_wq(pkg, 2)
        wq.add_tasks(0, 12)
        for r in range(4):
            wq.claim(r % 2, k=1, now=float(r))
        held = wq.log.tail(0)
        wq.log.register_consumer("c", len(wq.log))
        wq.log.truncate()
        for r in range(4, 6):
            wq.claim(r % 2, k=1, now=float(r))
        recs = held + wq.log.tail(wq.log.base)
        return wq, [b"".join(bytes(c) for c in f)
                    for f in w.iter_frames(recs)]
    port, pframes = run(T, wire)
    _, rframes = run(R, ref_wire)
    assert [struct.unpack_from("<HBBIQ", f)[1] for f in pframes] \
        == [struct.unpack_from("<HBBIQ", f)[1] for f in rframes]
    assert pframes[0][2] == wire.FT_COLD
    dec = wire.decode_delta(b"".join(pframes))
    store = ColumnStore(port.store.schema, capacity=256)
    replication.replay(store, dec)
    assert_cols_equal(store, port.store, port.store.cols)
    with pytest.raises(wire.WireError):
        wire.decode_delta(b"\x00" * 32)
    with pytest.raises(wire.WireError):
        wire.decode_delta(pframes[-1][:-3])


def test_sweep_partial_codec_matches_the_reference():
    ref, port = scripted(R, 3), scripted(T, 3)
    rpart = ref_steering.sweep_partials(ref.store.snapshot_view(),
                                        ref.num_workers, 11.0, 60.0)
    ppart = steering.sweep_partials(port.store.snapshot_view(),
                                    port.num_workers, 11.0, 60.0)
    pbuf = wire.encode_sweep_partial(ppart)
    assert pbuf == ref_wire.encode_sweep_partial(rpart)
    back = ref_wire.decode_sweep_partial(pbuf)
    assert back.keys() == rpart.keys()
    for k in rpart:
        assert np.array_equal(np.asarray(back[k]), np.asarray(rpart[k]))
    with pytest.raises(wire.WireError):
        wire.decode_sweep_partial(pbuf + b"\x00")


def sweep_key(res):
    return json.dumps(res, sort_keys=True, default=str)


@pytest.mark.parametrize("transport", ["pipe", "tcp"])
def test_shipped_replica_matches_reference_primary(transport):
    """The port's replica process, synced across a truncate, a kill and a
    respawn: its columns are the reference primary's, bit for bit, its
    remote sweep is the reference's sweep, and its promote requeues the
    RUNNING rows as the reference's does."""
    seed = 3 if transport == "pipe" else 5
    rng = np.random.default_rng(seed)
    rrng = np.random.default_rng(seed)
    wq, ref = make_wq(T, 4), make_wq(R, 4)
    rep = replication.ShippedDeltaReplicator(wq, sync_every=8,
                                             transport=transport)
    rref = ref_replication.ShippedDeltaReplicator(ref, sync_every=8,
                                                  transport=transport)
    try:
        assert rep.remote_pid not in (None, os.getpid())
        assert rep.codec == rref.codec == "adaptive"
        for q, g in ((wq, rng), (ref, rrng)):
            q.add_tasks(0, 48, domain_in=g.uniform(0, 1, (48, 3)))
        mixed_workload(wq, T.SteeringEngine(wq), rng, rounds=6)
        mixed_workload(ref, R.SteeringEngine(ref), rrng, rounds=6)
        rep.sync()
        rref.sync()
        assert wq.compact_log() == ref.compact_log() > 0
        rep.process.kill()                  # dies with the next tail unsent
        rep.process.join(timeout=30)
        mixed_workload(wq, T.SteeringEngine(wq), rng, rounds=3)
        mixed_workload(ref, R.SteeringEngine(ref), rrng, rounds=3)
        view, rview = wq.store.snapshot_view(), ref.store.snapshot_view()
        rep.sync(upto_version=view.version)   # respawn + ship across it
        rref.sync(upto_version=rview.version)
        assert rep.spawn_count == 2
        state = rep.fetch_remote_state()
        assert state["pid"] != os.getpid()
        for name in wq.store.cols:
            assert np.array_equal(state["snapshot"]["cols"][name],
                                  rview.col(name), equal_nan=True), name
        assert sweep_key(rep.remote_sweep(42.0)) \
            == sweep_key(rref.remote_sweep(42.0))
        promoted, rpromoted = rep.promote(), rref.promote()
        assert promoted.device == wq.device
        assert_cols_equal(promoted.store, rpromoted.store, wq.store.cols)
        assert (promoted.store.col("status") != int(T.Status.RUNNING)).all()
    finally:
        rep.close()
        rref.close()
    assert not wq.log.has_consumer(rep.consumer)


def test_close_is_idempotent_after_a_child_crash():
    wq = make_wq(T, 2)
    rep = replication.ShippedDeltaReplicator(wq)
    wq.add_tasks(0, 4)
    rep.sync()
    rep.process.kill()
    rep.process.join(timeout=30)
    rep.close()
    assert rep.process is None and rep.tr is None
    rep.close()
    assert not wq.log.has_consumer(rep.consumer)
