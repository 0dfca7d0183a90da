"""Shard-primary failover in the port against the reference
(``tests/test_shard_failover.py``, ``tests/test_leases.py``): a port
router and a reference router run the same script beside a single-primary
oracle; one shard primary dies with claims in flight, the survivors keep
claiming id for id, ``promote_shard`` loses no committed task, and the
promoted shard claims as the oracle does (also through the ``wq_claim``
op's plain version). Sharded checkpoints restore at their version vector,
and the reference's ``Checkpointer`` restores the port's into equal
stores. The port's sharded ``TrainExecutor`` (fail and promote a shard,
checkpoints, replica analyst) writes the reference executor's store and
loss history."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer  # noqa: E402
from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.core import sharding_router as ref_sr  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.runtime.executor import TrainExecutor as RefTrainExecutor  # noqa: E402
from repro_torch import flags  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.risers_workflow import WorkflowConfig  # noqa: E402
from repro_torch.core import sharding_router as sr  # noqa: E402
from repro_torch.core.replication import (AllReplicasDeadError,  # noqa: E402
                                          make_replicator)
from repro_torch.core.schema import Status  # noqa: E402
from repro_torch.core.steering import SteeringEngine  # noqa: E402
from repro_torch.core.workqueue import WorkQueue  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.interop import train_state_from_jax  # noqa: E402
from repro_torch.runtime.executor import TrainExecutor  # noqa: E402
from test_torch_train_executor import HISTORY_REL_TOL  # noqa: E402

S, L = 3, 2
W = S * L
# the store columns a train run stamps with the wall clock
WALL_CLOCK_COLS = {"submit_time", "start_time", "end_time", "claimed_at",
                   "heartbeat_at", "expires_at", "out2"}


def _fp(x):
    return json.dumps(x, sort_keys=True, default=str)


def _dom(ids):
    h = (ids * 2654435761) % (1 << 10)
    return np.stack([(h % 977) / 976.0, ((h * 3) % 911) / 910.0,
                     ((h * 7) % 1013) / 1012.0], 1)


def _dom_out(ids):
    return np.stack([(ids % 7) / 8.0, (ids % 5) / 4.0, (ids % 3) / 2.0], 1)


def _load(r, n_per_act=48, activities=3):
    prev = None
    for a in range(activities):
        ids = np.arange(a * n_per_act, (a + 1) * n_per_act, dtype=np.int64)
        kw = dict(domain_in=_dom(ids), duration_est=1.0, now=0.0)
        if prev is not None:
            kw["parent_task"] = prev
        r.add_tasks(a, n_per_act, **kw)
        prev = ids


def _shard_rows(r, ids):
    out = []
    owner = r.shard_of(ids)
    for s in range(r.num_shards):
        m = owner == s
        if not m.any():
            continue
        tid = r.shards[s].wq.store.col("task_id")
        pos = np.searchsorted(tid, ids[m])
        assert np.array_equal(tid[pos], ids[m])
        out.append((s, pos))
    return out


def _router_ids(r, rc):
    return {g: np.sort(r.shards[s].wq.store.col("task_id")[rows])
            for g, (s, rows) in rc.items() if len(rows)}


def _finish(routers, o, ids, now):
    o.finish(ids, now=now, domain_out=_dom_out(ids))
    for r in routers:
        for s, pos in _shard_rows(r, ids):
            tid = r.shards[s].wq.store.col("task_id")[pos]
            r.shards[s].wq.finish(pos, now=now, domain_out=_dom_out(tid))


def _claim_round(routers, o, clock, *, skip_shard=None):
    """One k=2 claim on every router and the oracle (the oracle skips the
    dead shard's workers): equal id for id. Returns the claimed ids."""
    if skip_shard is None:
        oc = o.claim_all(k=2, now=clock, steal=False)
        o_ids = {g: np.sort(o.store.col("task_id")[v])
                 for g, v in oc.items() if len(v)}
    else:
        o_ids = {}
        for g in range(W):
            if g // L == skip_shard:
                continue
            rows = o.claim(g, k=2, now=clock, allow_steal=False)
            if len(rows):
                o_ids[g] = np.sort(o.store.col("task_id")[rows])
    for r in routers:
        r_ids = _router_ids(r, r.claim_all(k=2, now=clock, steal=False))
        assert r_ids.keys() == o_ids.keys()
        assert all(np.array_equal(r_ids[g], o_ids[g]) for g in o_ids)
    return (np.sort(np.concatenate(list(o_ids.values())))
            if o_ids else np.empty(0, np.int64))


@pytest.mark.parametrize("device_claim", [False, True])
def test_fail_and_promote_shard_matches_oracle_and_reference(device_claim):
    port = sr.ShardRouter(S, L, replicate="delta", sync_every=1 << 20,
                          device="cpu", device_claim=device_claim)
    ref = ref_sr.ShardRouter(S, L, replicate="delta", sync_every=1 << 20)
    o = WorkQueue(num_workers=W, device="cpu", device_claim=False)
    for r in (port, ref, o):
        _load(r)
    routers = [port, ref]
    clock = 1.0
    for _ in range(3):
        _finish(routers, o, _claim_round(routers, o, clock), clock + 1.0)
        clock += 2.0
    claimed = _claim_round(routers, o, clock)       # claims in flight
    strand = claimed[(claimed % W) // L == 0]
    assert len(strand)
    _finish(routers, o, np.setdiff1d(claimed, strand), clock + 1.0)
    for r in routers:
        r.fail_shard(0)
        assert r.shards[0].replicator.lag() > 0
    with pytest.raises(RuntimeError):
        port.add_tasks(0, W, now=clock)
    clock += 2.0
    for _ in range(2):                              # the dead window
        done = _claim_round(routers, o, clock, skip_shard=0)
        assert len(done)
        _finish(routers, o, done, clock + 1.0)
        clock += 2.0
    wq0 = port.promote_shard(0)     # the router's own device_claim
    ref.promote_shard(0)
    assert port.shards[0].wq is wq0 and wq0.device_claim is device_claim
    assert str(wq0.device) == "cpu"
    assert not (wq0.store.col("status") == int(Status.RUNNING)).any()
    tid, st = o.store.col("task_id"), o.store.col("status")
    rows = np.nonzero((st == int(Status.RUNNING)) & ((tid % W) // L == 0))[0]
    assert len(rows) == len(strand)
    o.store.update(rows, status=int(Status.READY))
    o.invalidate_cursors(rows)
    assert np.array_equal(port.live_task_ids(), np.arange(3 * 48))
    while True:                                     # lockstep drain
        done = _claim_round(routers, o, clock)
        if not len(done):
            break
        _finish(routers, o, done, clock + 1.0)
        clock += 2.0
    assert port.tasks_left() == 0
    ov = o.store.snapshot_view()
    merged = sr.ShardRouter.comparable(
        port.run_all(clock, views=port.snapshot_vector()))
    assert _fp(merged) == _fp(sr.ShardRouter.oracle_normalize(
        SteeringEngine(o).run_all(clock, view=ov), ov))
    assert _fp(merged) == _fp(ref_sr.ShardRouter.comparable(
        ref.run_all(clock, views=ref.snapshot_vector())))
    sh = port.shards[0]
    sh.replicator.sync()
    for n in sh.wq.store.cols:
        assert np.array_equal(sh.wq.store.col(n), sh.replicator.store.col(n),
                              equal_nan=True), n
    port.check_invariants()
    port.close()
    ref.close()


@pytest.mark.parametrize("router_claim,flag,want", [
    (True, False, True), (False, True, False),
    (None, True, True), (None, False, False)])
def test_promoted_shard_claims_as_the_router_was_told(router_claim, flag,
                                                      want):
    """A router built with ``device_claim`` keeps it across a failover,
    whatever the flag at promote time; a router built with None follows
    the flag then, as the reference's promote does."""
    r = sr.ShardRouter(S, L, replicate="delta", sync_every=4, device="cpu",
                       device_claim=router_claim)
    r.add_tasks(0, 4 * W, duration_est=1.0, now=0.0)
    r.claim_all(k=1, now=1.0, steal=False)
    r.fail_shard(1)
    with flags.device_claims(flag):
        wq1 = r.promote_shard(1)
    assert wq1.device_claim is want and str(wq1.device) == "cpu"
    got = r.claim_all(k=1, now=2.0, steal=False)
    assert sum(len(rows) for s, rows in got.values() if s == 1) == L
    r.close()


def test_supervision_promote_and_unrecoverable_shards():
    r = sr.ShardRouter(S, L, replicate="delta", sync_every=4, device="cpu")
    r.attach_supervision(WorkflowConfig(name="drill", activities=("a0",)))
    r.add_tasks(0, 4 * W, duration_est=1.0, now=0.0)
    r.claim_all(k=1, now=1.0, steal=False)
    r.sync_secondaries()
    gen0 = r.shards[2].supervisor.state.generation
    r.fail_shard(2)
    assert r.shards[2].supervisor.alive is False
    wq2 = r.promote_shard(2)
    sup = r.shards[2].supervisor
    assert sup.alive and sup.wq is wq2
    assert sup.state.generation == gen0 + 1
    r.close()
    bare = sr.ShardRouter(2, 1, device="cpu")
    bare.attach_supervision(WorkflowConfig(name="m", activities=("a", "b")))
    with pytest.raises(ValueError):
        bare.expand_all()
    bare.add_tasks(0, 4, now=0.0)
    bare.fail_shard(1)
    with pytest.raises(sr.UnrecoverableShardError):
        bare.promote_shard(1)
    bare.close()


def test_replica_group_all_dead_raises():
    wq = WorkQueue(num_workers=2, device="cpu")
    wq.add_tasks(0, 8, now=0.0)
    rep = make_replicator(wq, "group", replicas=2, sync_every=4)
    try:
        rep.sync()
        for m in rep.members:
            m.process.kill()
            m.process.join(timeout=30)
        with pytest.raises(AllReplicasDeadError):
            rep.promote()
    finally:
        rep.close()


def test_steal_rolls_back_when_transport_dies():
    r = sr.ShardRouter(2, 2, replicate="delta", sync_every=4, device="cpu")
    r.add_tasks(0, 64, duration_est=1.0, now=0.0)
    sh0 = r.shards[0]
    got = sh0.wq.claim_all(k=32, now=1.0)
    sh0.wq.finish(np.concatenate([v for v in got.values() if len(v)]),
                  now=2.0)
    live = r.live_task_ids()
    r._steal_tx.close()
    assert r.rebalance(now=3.0) == 0
    assert r.steal_stats.rollbacks >= 1
    assert np.array_equal(live, r.live_task_ids())
    rep = r.shards[1].replicator
    rep.sync()
    for n in r.shards[1].wq.store.cols:
        assert np.array_equal(r.shards[1].wq.store.col(n), rep.store.col(n),
                              equal_nan=True), n
    r.check_invariants()
    r.close()


def test_sharded_reap_feeds_cross_shard_stealing():
    """Twin of test_leases.py's sharded reap: the same counts of reaped
    and moved tasks as the reference, the same final shards."""
    out = {}
    for mod in (sr, ref_sr):
        kw = {"device": "cpu"} if mod is sr else {}
        router = mod.ShardRouter(2, 2, lease_s=5.0, **kw)
        router.add_tasks(0, 24, now=0.0)
        live = router.live_task_ids()
        router.claim_all(k=3, now=0.0)
        sh0, sh1 = router.shards
        run0 = np.nonzero(sh0.wq.store.col("status")
                          == int(Status.RUNNING))[0]
        sh0.wq.finish(run0, now=1.0)
        reaped = router.reap_expired(now=6.0)
        while int(sh0.wq.ready_counts().sum()):
            got = sh0.wq.claim_all(k=4, now=7.0)
            sh0.wq.finish(np.concatenate(list(got.values())), now=8.0)
        moved = router.rebalance(now=9.0)
        assert moved > 0 and reaped > 0
        assert np.array_equal(router.live_task_ids(), live)
        out[mod] = (reaped, moved, router)
    assert out[sr][:2] == out[ref_sr][:2]
    for psh, rsh in zip(out[sr][2].shards, out[ref_sr][2].shards):
        for n in psh.wq.store.cols:
            assert np.array_equal(psh.wq.store.col(n), rsh.wq.store.col(n),
                                  equal_nan=True), n
    for *_, r in out.values():
        r.close()


def test_sharded_checkpoint_restores_in_both_packages(tmp_path):
    """One atomic manifest per version vector: the port restores it into a
    router at that vector with an equal merged sweep, and the reference's
    ``Checkpointer.restore(router_kw=...)`` reads the same files into
    equal stores."""
    r = sr.ShardRouter(S, L, replicate="delta", sync_every=8, device="cpu")
    _load(r, 32)
    clock = 1.0
    for _ in range(4):
        rc = r.claim_all(k=2, now=clock, steal=False)
        ids = np.sort(np.concatenate(
            [r.shards[s].wq.store.col("task_id")[rows]
             for s, rows in rc.values() if len(rows)]))
        for s, pos in _shard_rows(r, ids):
            tid = r.shards[s].wq.store.col("task_id")[pos]
            r.shards[s].wq.finish(pos, now=clock + 1.0,
                                  domain_out=_dom_out(tid))
        clock += 2.0
    ck = Checkpointer(str(tmp_path), async_write=False)
    state = {"w": torch.arange(8.0)}
    with pytest.raises(ValueError):
        ck.save(1, state, r.shards[0].wq, router=r)
    vec = [int(v) for v in r.version_vector()]
    fp = _fp(sr.ShardRouter.comparable(
        r.run_all(clock, views=r.snapshot_vector())))
    ck.save(1, state, router=r)
    man = json.loads(
        (tmp_path / "step_00000001" / "manifest.json").read_text())
    assert man["version_vector"] == vec
    assert man["store_files"] == [f"store_{i}.npz" for i in range(S)]
    step, got, r2 = ck.restore({"w": torch.zeros(8)},
                               router_kw={"replicate": "delta",
                                          "device": "cpu"})
    assert step == 1 and isinstance(r2, sr.ShardRouter)
    assert torch.equal(got["w"], state["w"])
    assert [int(v) for v in r2.version_vector()] == vec
    assert _fp(sr.ShardRouter.comparable(
        r2.run_all(clock, views=r2.snapshot_vector()))) == fp
    assert all(sh.wq.log.has_consumer("checkpointer") for sh in r2.shards)
    assert all(str(sh.wq.device) == "cpu" for sh in r2.shards)
    fresh = r2.add_tasks(0, W, now=clock)
    assert int(fresh.min()) > int(r.live_task_ids().max())
    rstep, rstate, rr = RefCheckpointer(str(tmp_path)).restore(
        {"w": np.zeros(8, np.float32)}, router_kw={"replicate": "delta"})
    assert rstep == 1 and isinstance(rr, ref_sr.ShardRouter)
    assert np.array_equal(rstate["w"], np.arange(8.0))
    assert [int(v) for v in rr.version_vector()] == vec
    for psh, rsh in zip(r.shards, rr.shards):
        for n in psh.wq.store.cols:
            assert np.array_equal(psh.wq.store.col(n), rsh.wq.store.col(n),
                                  equal_nan=True), n
    for x in (r, r2, rr):
        x.close()


def test_sharded_executor_matches_the_reference(tmp_path):
    """The sharded executor, port against reference from the same params:
    2 shards of 2 workers, the in-process replica analyst, a checkpoint
    every 4 steps, shard 1 failed and promoted after 6 ticks. Every store
    column but the wall-clock ones is equal, the loss history is within
    the history test's limit, and the port's checkpoint restores into a
    router."""
    cfg, jcfg = smoke_config("qwen2-0.5b"), ref_smoke_config("qwen2-0.5b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4)
    jdata = ref_pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    batch_size=4)
    kw = dict(num_workers=4, shards=2, analyst="replica", checkpoint_every=4,
              steer_every=2)
    ref = RefTrainExecutor(jcfg, data_cfg=jdata,
                           checkpointer=RefCheckpointer(
                               str(tmp_path / "ref"), async_write=False),
                           **kw)
    ex = TrainExecutor(cfg, data_cfg=data, device="cpu",
                       checkpointer=Checkpointer(str(tmp_path / "port"),
                                                 async_write=False), **kw)
    ex.state = train_state_from_jax(cfg, jax.tree.map(np.asarray, ref.state),
                                    ex.state["params"])
    for e in (ex, ref):
        e.submit_steps(8)
        for _ in range(6):
            e.tick()
        e.fail_shard(1)
        e.promote_shard(1)
    hist, want = ex.run(), ref.run()
    ex.close()
    ref.close()
    assert ex.router.tasks_left() == 0 and len(hist) == len(want) >= 8
    assert ex.router.shards[1].supervisor.state.generation >= 1
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in want],
                               rtol=HISTORY_REL_TOL)
    for psh, rsh in zip(ex.router.shards, ref.router.shards):
        for n in psh.wq.store.cols:
            if n in WALL_CLOCK_COLS:
                continue
            a, b = psh.wq.store.col(n), rsh.wq.store.col(n)
            if n in ("out0", "out1"):
                np.testing.assert_allclose(a, b, rtol=HISTORY_REL_TOL)
            else:
                assert np.array_equal(a, b, equal_nan=True), n
    step, _, r2 = Checkpointer(str(tmp_path / "port")).restore(
        ex.state, router_kw={"device": "cpu"})
    assert isinstance(r2, sr.ShardRouter) and step >= 4
    r2.close()
