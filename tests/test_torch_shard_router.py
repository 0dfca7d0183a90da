"""The port's sharding router (``repro_torch.core.sharding_router``)
against the reference's (``tests/test_shard_router.py``,
``tests/test_steering_fanout.py``): one numpy-seeded script of claims,
fails, finishes and steering writes drives a port router, a reference
router and a single-primary oracle; claims are equal id for id every round
(also with every shard claiming through the ``wq_claim`` op's plain
version), the scatter-gather and remote Q1-Q7 sweeps at a pinned version
vector equal the oracle's and the reference router's bit for bit, per-shard
replicas replay to parity across a truncate, and a rebalance conserves the
live task ids and moves what the reference's moves."""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import sharding_router as ref_sr  # noqa: E402
from repro.core.steering import SteeringEngine as RefSteering  # noqa: E402
from repro_torch.core import sharding_router as sr  # noqa: E402
from repro_torch.core.schema import Status  # noqa: E402
from repro_torch.core.steering import SteeringEngine, sweep_partials  # noqa: E402
from repro_torch.core.workqueue import WorkQueue  # noqa: E402

S, L = 4, 4
W = S * L


def _fp(x):
    return json.dumps(x, sort_keys=True, default=str)


def _dom(ids):
    h = (ids * 2654435761) % (1 << 10)
    return np.stack([(h % 977) / 976.0, ((h * 3) % 911) / 910.0,
                     ((h * 7) % 1013) / 1012.0], 1)


def _dom_out(ids):
    # dyadic denominators: exact in float64, so merged sums are bit-stable
    return np.stack([(ids % 7) / 8.0, (ids % 5) / 4.0, (ids % 3) / 2.0], 1)


def _load(r, n_per_act, activities=3):
    prev = None
    for a in range(activities):
        ids = np.arange(a * n_per_act, (a + 1) * n_per_act, dtype=np.int64)
        kw = dict(domain_in=_dom(ids), duration_est=1.0, now=0.0)
        if prev is not None:
            kw["parent_task"] = prev
        assert np.array_equal(r.add_tasks(a, n_per_act, **kw), ids)
        prev = ids


def _trio(n_per_act=40, device_claim=False, **router_kw):
    """A port router, a reference router and a port single-primary oracle
    loaded with the identical chained workflow."""
    port = sr.ShardRouter(S, L, device="cpu", device_claim=device_claim,
                          **router_kw)
    ref = ref_sr.ShardRouter(S, L, **router_kw)
    oracle = WorkQueue(num_workers=W, device="cpu", device_claim=False)
    for r in (port, ref, oracle):
        _load(r, n_per_act)
    return port, ref, oracle


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


def _drive(routers, o, rng, rounds, clock=1.0):
    """Mirrored claims (k drawn per round), fails and finishes on every
    router and the oracle, with a Q8 patch and a prune at random rounds;
    asserts id-for-id claim parity each round. Returns the clock."""
    patch_rnd = int(rng.integers(0, max(rounds, 1)))
    prune_rnd = int(rng.integers(0, max(rounds, 1)))
    for rnd in range(rounds):
        k = int(rng.integers(1, 4))
        oc = o.claim_all(k=k, now=clock, steal=False)
        o_ids = {g: np.sort(o.store.col("task_id")[rows])
                 for g, rows in oc.items() if len(rows)}
        for r in routers:
            r_ids = _router_ids(r, r.claim_all(k=k, now=clock, steal=False))
            assert r_ids.keys() == o_ids.keys(), rnd
            assert all(np.array_equal(r_ids[g], o_ids[g]) for g in o_ids)
        if o_ids:
            all_ids = np.sort(np.concatenate(list(o_ids.values())))
            stride = int(rng.integers(3, 9))
            fail_ids = all_ids[::stride] if rng.random() < 0.4 \
                else all_ids[:0]
            fin = np.setdiff1d(all_ids, fail_ids)
            fa, fb = fin[fin % 2 == 0], fin[fin % 2 == 1]
            if len(fail_ids):
                o.fail(fail_ids, now=clock + 0.25)
                for r in routers:
                    for s, pos in _shard_rows(r, fail_ids):
                        r.shards[s].wq.fail(pos, now=clock + 0.25)
            for ids_, dt in ((fa, 1.0), (fb, 1.5)):
                if not len(ids_):
                    continue
                o.finish(ids_, now=clock + dt, domain_out=_dom_out(ids_))
                for r in routers:
                    for s, pos in _shard_rows(r, ids_):
                        tid = r.shards[s].wq.store.col("task_id")[pos]
                        r.shards[s].wq.finish(pos, now=clock + dt,
                                              domain_out=_dom_out(tid))
        steer = [SteeringEngine(o)] + [
            (SteeringEngine if isinstance(r, sr.ShardRouter)
             else RefSteering)(sh.wq) for r in routers for sh in r.shards]
        if rnd == patch_rnd:
            for se in steer:
                se.q8_patch_ready(0, "in0", 9.5, predicate=lambda v: v > 0.8)
        if rnd == prune_rnd:
            for se in steer:
                se.prune("in1", 0.0, 0.05)
        clock += 2.0
    return clock


def _oracle_sweep(o, clock):
    ov = o.store.snapshot_view()
    return sr.ShardRouter.oracle_normalize(
        SteeringEngine(o).run_all(clock, view=ov), ov)


def _assert_shards_equal(port, ref):
    for psh, rsh in zip(port.shards, ref.shards):
        for n in psh.wq.store.cols:
            assert np.array_equal(psh.wq.store.col(n), rsh.wq.store.col(n),
                                  equal_nan=True), (psh.index, n)


def test_shard_map_and_scatter_match_the_reference():
    port, ref = sr.ShardRouter(S, L, device="cpu"), ref_sr.ShardRouter(S, L)
    ids = np.arange(1000, dtype=np.int64)
    assert np.array_equal(port.shard_of(ids), ref.shard_of(ids))
    assert np.array_equal(port.global_worker(port.shard_of(ids), ids % L),
                          ids % W)
    for r in (port, ref):
        r.add_tasks(0, 100, domain_in=_dom(np.arange(100)), now=0.0)
    _assert_shards_equal(port, ref)
    port.check_invariants()
    assert all(str(sh.wq.device) == "cpu" for sh in port.shards)
    port.close()
    ref.close()


@pytest.mark.parametrize("device_claim", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_claims_and_merged_sweep_match_oracle_and_reference(device_claim,
                                                            seed):
    rng = np.random.default_rng(seed)
    port, ref, o = _trio(device_claim=device_claim)
    assert all(sh.wq.device_claim is device_claim for sh in port.shards)
    clock = _drive([port, ref], o, rng, rounds=6)
    extra = np.arange(120, 150, dtype=np.int64)   # open tasks: Q4/Q5/Q6
    for r in (port, ref, o):
        r.add_tasks(0, 30, domain_in=_dom(extra), duration_est=1.0,
                    now=clock)
    merged = sr.ShardRouter.comparable(
        port.run_all(clock, views=port.snapshot_vector()))
    rmerged = ref_sr.ShardRouter.comparable(
        ref.run_all(clock, views=ref.snapshot_vector()))
    assert _fp(merged) == _fp(_oracle_sweep(o, clock)) == _fp(rmerged)
    assert merged["q1"] and merged["q4"] > 0 and merged["q6"]
    assert port.version_vector() == ref.version_vector()
    _assert_shards_equal(port, ref)
    port.close()
    ref.close()


def test_version_vector_pins_the_sweep():
    port, _, o = _trio()
    clock = _drive([port], o, np.random.default_rng(2), rounds=4)
    views = port.snapshot_vector()
    before = _fp(port.run_all(clock, views=views))
    port.add_tasks(0, 50, now=clock)
    port.claim_all(k=1, now=clock + 2.0)
    assert _fp(port.run_all(clock, views=views)) == before
    assert _fp(port.run_all(clock)) != before
    port.close()


def test_per_shard_replicas_replay_to_parity_across_truncate():
    port, _, o = _trio(replicate="delta", sync_every=8)
    rng = np.random.default_rng(3)
    clock = _drive([port], o, rng, rounds=5)
    port.sync_replicas()
    port.compact()
    assert all(sh.wq.log.base > 0 for sh in port.shards)
    clock = _drive([port], o, rng, rounds=2, clock=clock)
    views = port.snapshot_vector()
    for s, sh in enumerate(port.shards):
        sh.replicator.sync(upto_version=views[s].version)
        for n in sh.wq.store.cols:
            assert np.array_equal(views[s].col(n), sh.replicator.store.col(n),
                                  equal_nan=True), (s, n)
    merged = port.run_all(clock, views=port.replica_vector())
    assert _fp(sr.ShardRouter.comparable(merged)) \
        == _fp(_oracle_sweep(o, clock))
    lags = port.consumer_lags()
    assert all(k.startswith("shard") for k in lags)
    port.close()


def test_rebalance_conserves_tasks_and_moves_what_the_reference_moves():
    out = {}
    for mod in (sr, ref_sr):
        kw = {"device": "cpu"} if mod is sr else {}
        r = mod.ShardRouter(S, L, replicate="delta", **kw)
        r.add_tasks(0, 12 * W, domain_in=_dom(np.arange(12 * W)), now=0.0)
        sh0 = r.shards[0]
        while sh0.wq.ready_counts().sum() > 0:
            got = sh0.wq.claim_all(k=64, now=1.0)
            sh0.wq.finish(np.concatenate([v for v in got.values()
                                          if len(v)]), now=2.0)
        live = r.live_task_ids()
        moved = r.rebalance(now=3.0)
        assert moved > 0 and r.steal_stats.tasks == moved
        assert np.array_equal(live, r.live_task_ids())
        assert sum(len(v) for v in sh0.wq.claim_all(k=4, now=4.0).values())
        r.sync_replicas()
        for sh in r.shards:
            v = sh.wq.store.snapshot_view()
            sh.replicator.sync(upto_version=v.version)
            for n in sh.wq.store.cols:
                assert np.array_equal(v.col(n), sh.replicator.store.col(n),
                                      equal_nan=True), (sh.index, n)
        r.check_invariants()
        out[mod] = (moved, r)
    assert out[sr][0] == out[ref_sr][0]
    _assert_shards_equal(out[sr][1], out[ref_sr][1])
    for _, r in out.values():
        r.close()
    noop = sr.ShardRouter(S, L, device="cpu")
    noop.add_tasks(0, 8 * W, now=0.0)
    assert noop.rebalance(now=1.0) == 0
    noop.close()


def test_merged_partials_equal_the_oracle_sweep():
    port, _, o = _trio(n_per_act=24)
    clock = _drive([port], o, np.random.default_rng(4), rounds=5)
    parts = [sweep_partials(v, L, clock, 60.0)
             for v in port.snapshot_vector()]
    merged = sr.merge_partials(parts)
    assert _fp(sr.ShardRouter.comparable(
        {**merged, "version": list(port.version_vector())})) \
        == _fp(sr.ShardRouter.comparable(
            port.run_all(clock, views=port.snapshot_vector())))
    with pytest.raises(ValueError):
        sr.merge_partials([])
    port.close()


def test_remote_sweep_matches_oracle_and_reference_across_truncate():
    """The per-shard replica processes: partial sweeps run there and are
    merged here, at a pinned vector, across a per-shard truncate; equal to
    the local merge, the oracle and the reference router's remote sweep;
    the serial scatter equals the concurrent one; a dead shard raises
    until it is promoted."""
    rng = np.random.default_rng(7)
    port, ref, o = _trio(replicate="remote", sync_every=8)
    try:
        clock = _drive([port, ref], o, rng, rounds=4)
        for r in (port, ref):
            r.sync_replicas()
            assert r.compact() > 0
        clock = _drive([port, ref], o, rng, rounds=3, clock=clock)
        vec, rvec = port.sync_replicas(), ref.sync_replicas()
        assert tuple(vec) == tuple(rvec)
        res = port.remote_sweep(clock, versions=vec, sync=False)
        rres = ref.remote_sweep(clock, versions=rvec, sync=False)
        assert _fp(res) == _fp(rres)
        assert _fp(res) == _fp(port.run_all(clock,
                                            views=port.snapshot_vector()))
        assert _fp(sr.ShardRouter.comparable(res)) \
            == _fp(_oracle_sweep(o, clock))
        assert _fp(port.remote_sweep(clock, versions=vec, sync=False,
                                     concurrent_scatter=False)) == _fp(res)
        with pytest.raises(RuntimeError, match="expected pinned"):
            port.remote_sweep(clock, versions=[v + 1 for v in vec],
                              sync=False)
        port.fail_shard(1)
        with pytest.raises(sr.DeadShardError, match="shard 1 is down"):
            port.remote_sweep(clock)
        wq = port.promote_shard(1)
        assert str(wq.device) == "cpu"
        assert not (wq.store.col("status") == int(Status.RUNNING)).any()
        assert _fp(port.remote_sweep(clock)) == _fp(port.run_all(clock))
    finally:
        port.close()
        ref.close()
    port.close()                              # idempotent
