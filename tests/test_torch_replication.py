"""The port's replication (``repro_torch.core.replication``) against the
reference's (``tests/test_replication.py``, ``test_replicator_api.py``,
``test_fabric.py``): one numpy-seeded operation script drives a primary in
each package, each with the same kind of replicator, and the replicas'
columns, their sweeps and their promoted queues are equal across the
packages. The promoted queue claims on the device of the queue it
replaces, with ``device_claim`` sampled from the flag at promote time, as
the reference's; a spawned replica loads neither torch nor the reference
package."""
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro import flags as ref_flags  # noqa: E402
from repro.core import replication as ref_replication  # noqa: E402
from repro_torch import flags  # noqa: E402
from repro_torch.configs.risers_workflow import WorkflowConfig  # noqa: E402
from repro_torch.core import replication  # noqa: E402
from repro_torch.core.supervisor import (SecondarySupervisor,  # noqa: E402
                                         Supervisor)

MODES = ["delta", "shipped", "remote", "full"]
PKG_REPL = {R: ref_replication, T: replication}


def sweep_key(res):
    return json.dumps(res, sort_keys=True, default=str)


def make_wq(pkg, workers, **kw):
    if pkg is T:
        kw.setdefault("device", "cpu")
    return pkg.WorkQueue(num_workers=workers, **kw)


def run_mixed_workload(wq, steer, rng, rounds=12):
    """Claims, finishes, fails, a requeue, a steering patch and prune, a
    resize: every replayable op kind."""
    for r in range(rounds):
        out = wq.claim_all(k=1, now=float(r))
        got = [v for v in out.values() if len(v)]
        rows = np.concatenate(got) if got else np.empty(0, np.int64)
        if len(rows) == 0:
            break
        if r == 2:
            wq.fail(rows[: max(len(rows) // 4, 1)], now=float(r) + 0.2)
            rows = rows[max(len(rows) // 4, 1):]
        if r == 3:
            victim = wq.num_workers - 1
            wid = wq.store.col("worker_id")[rows]
            wq.requeue_worker(victim)
            rows = rows[wid != victim]
        if len(rows):
            wq.finish(rows, now=float(r) + 0.9,
                      domain_out=rng.normal(0.5, 0.3, (len(rows), 3)))
        if r == 4:
            steer.q8_patch_ready(0, "in0", 5.0, predicate=lambda v: v > 0.6)
        if r == 5:
            steer.prune("in1", 0.0, 0.05)
        if r == 6 and wq.num_workers > 2:
            wq.resize(wq.num_workers - 1)


def scripted(pkg, mode, seed=11, workers=4, n=60, rounds=12, **rkw):
    """A primary in ``pkg`` with a ``mode`` replicator, after the script;
    the replica is synced to the primary's version."""
    rng = np.random.default_rng(seed)
    wq = make_wq(pkg, workers)
    rep = PKG_REPL[pkg].make_replicator(wq, mode, sync_every=1, **rkw)
    wq.add_tasks(0, n, domain_in=rng.uniform(0, 1, (n, 3)))
    run_mixed_workload(wq, pkg.SteeringEngine(wq), rng, rounds=rounds)
    rep.sync(upto_version=wq.store.version)
    rep.flush()
    return wq, rep


def assert_cols_equal(a, b, names):
    for name in names:
        assert np.array_equal(a.col(name), b.col(name), equal_nan=True), name


@pytest.mark.parametrize("mode", MODES)
def test_replicator_matches_the_reference(mode):
    """Every arm: the replica's columns (here, or fetched from the replica
    process) equal the reference replica's, the sweeps on them are equal,
    and the promoted queues are equal with no RUNNING row left."""
    kw = {"replicas": 2} if mode == "remote" else {}
    wq, rep = scripted(T, mode, **kw)
    rwq, rrep = scripted(R, mode, **kw)
    try:
        assert isinstance(rep, replication.Replicator)
        assert rep.lag() == rrep.lag() == 0
        assert set(rep.stats()) == set(rrep.stats())
        names = list(wq.store.cols)
        assert_cols_equal(wq.store, rwq.store, names)
        if mode == "delta":
            assert_cols_equal(rep.store, rrep.store, names)
            assert rep.store.version == rrep.store.version
            assert rep.records_applied == rrep.records_applied > 0
        elif mode in ("shipped", "remote"):
            members = rep.members if mode == "remote" else [rep]
            for m in members:
                cols = m.fetch_remote_state()["snapshot"]["cols"]
                for name in names:
                    assert np.array_equal(cols[name], rwq.store.col(name),
                                          equal_nan=True), name
            assert sweep_key(rep.remote_sweep(50.0)) \
                == sweep_key(rrep.remote_sweep(50.0))
        view = wq.store.snapshot_view()
        assert sweep_key(T.SteeringEngine(wq).run_all(50.0, view=view)) \
            == sweep_key(R.SteeringEngine(rwq).run_all(
                50.0, view=rwq.store.snapshot_view()))
        promoted, rpromoted = rep.promote(), rrep.promote()
        assert_cols_equal(promoted.store, rpromoted.store, names)
        assert (promoted.store.col("status")
                != int(T.Status.RUNNING)).all()
        assert promoted._next_task_id == rpromoted._next_task_id
    finally:
        rep.close()
        rrep.close()


def test_make_replicator_modes_and_aliases():
    wq = make_wq(T, 2)
    for mode, cls in (("delta", replication.DeltaReplicator),
                      ("local", replication.DeltaReplicator),
                      ("replica", replication.DeltaReplicator),
                      ("full", replication.FullCopyReplica)):
        rep = replication.make_replicator(wq, mode)
        assert type(rep) is cls
        rep.close()
    with pytest.raises(ValueError, match="single-replica"):
        replication.make_replicator(wq, "delta", replicas=2)
    with pytest.raises(ValueError, match="unknown replicator mode"):
        replication.make_replicator(wq, "carrier-pigeon")
    assert replication.ReplicaSet is replication.DeltaReplicator
    assert replication.ReplicationFabric is replication.ReplicaGroup


@pytest.mark.parametrize("flag", [False, True])
def test_promoted_queue_claims_where_the_reference_rule_says(flag):
    """The promoted queue keeps the replaced queue's device and samples
    ``device_claim`` from the flag at promote time, as the reference
    samples its own flag; its claims then equal the reference's."""
    wq, rep = scripted(T, "delta", seed=3)
    rwq, rrep = scripted(R, "delta", seed=3)
    assert not wq.device_claim
    with flags.device_claims(flag), ref_flags.device_claims(flag):
        promoted, rpromoted = rep.promote(), rrep.promote()
    assert str(promoted.device) == str(wq.device) == "cpu"
    assert promoted.device_claim is rpromoted.device_claim is flag
    promoted.add_tasks(0, 8, now=99.0)
    rpromoted.add_tasks(0, 8, now=99.0)
    for r in range(3):
        got = promoted.claim_all(k=2, now=100.0 + r)
        want = rpromoted.claim_all(k=2, now=100.0 + r)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[w], want[w]) for w in want)


def test_group_fanout_floor_and_election_match_the_reference():
    """A 3-member group: a laggard pins the compaction floor; after the
    leader dies, promote crowns the highest-acked survivor; the promoted
    queue equals the reference group's."""
    out = {}
    for pkg in (T, R):
        rng = np.random.default_rng(0)
        wq = make_wq(pkg, 3)
        grp = PKG_REPL[pkg].ReplicaGroup(wq, n_replicas=3, sync_every=8)
        try:
            assert len({m.consumer for m in grp.members}) == 3
            wq.add_tasks(0, 24, domain_in=rng.uniform(0, 1, (24, 3)))
            run_mixed_workload(wq, pkg.SteeringEngine(wq), rng, rounds=3)
            grp.members[0].sync()
            grp.members[1].sync()
            laggard = grp.members[2].offset
            wq.compact_log()
            assert wq.log.base <= laggard
            assert wq.consumer_lags()[grp.members[2].consumer] > 0
            grp.sync()
            grp.members[0].process.kill()
            grp.members[0].process.join(timeout=30)
            run_mixed_workload(wq, pkg.SteeringEngine(wq), rng, rounds=2)
            out[pkg] = (grp.promote(), grp)
        finally:
            grp.close()
    promoted, rpromoted = out[T][0], out[R][0]
    assert_cols_equal(promoted.store, rpromoted.store, promoted.store.cols)
    assert str(promoted.device) == "cpu"


def drive(wq, sup, rng, *, crash_at=None, replica=None, secondary=None,
          max_rounds=200):
    """Run the workflow to its end; at round ``crash_at`` the primary and
    its supervisor die and the run goes on from the recovered pair."""
    r = 0
    while r < max_rounds:
        if crash_at is not None and r == crash_at:
            sup.crash()
            wq = replica.recover()
            sup = secondary.promote(wq)
        out = wq.claim_all(k=1, now=float(r))
        got = [v for v in out.values() if len(v)]
        rows = np.concatenate(got) if got else np.empty(0, np.int64)
        if len(rows):
            wq.finish(rows, now=float(r) + 0.9,
                      domain_out=rng.normal(0.5, 0.3, (len(rows), 3)))
        n_new = sup.expand(now=float(r))
        if len(rows) == 0 and n_new == 0:
            break
        r += 1
    return wq, sup


def test_crash_failover_loses_no_task():
    """Twin of test_replication.py's crash failover: the primary and its
    supervisor die at round 2 with a lagging replica; the recovered queue
    and the promoted supervisor finish the workflow, and the final store
    is the reference's, column for column."""
    from repro.configs.risers_workflow import WorkflowConfig as RefWf
    from repro.core import supervisor as ref_sup
    out = {}
    for pkg, sup_mod, wf_cls in ((T, None, WorkflowConfig),
                                 (R, ref_sup, RefWf)):
        wf = wf_cls(activities=("a0", "a1", "a2"))
        rng = np.random.default_rng(7)
        wq = make_wq(pkg, 3)
        sup = (sup_mod.Supervisor if sup_mod else Supervisor)(wq, wf)
        sup.seed(18, duration_s=1.0, rng=rng)
        replica = PKG_REPL[pkg].DeltaReplicator(wq, sync_every=4)
        secondary = (sup_mod.SecondarySupervisor if sup_mod
                     else SecondarySupervisor)(sup)
        for _ in range(2):
            replica.maybe_sync()
        secondary.sync()
        wq2, sup2 = drive(wq, sup, rng, crash_at=2, replica=replica,
                          secondary=secondary)
        assert wq2 is not wq and sup2.done()
        assert sup2.state.generation == 1
        assert wq2.counts()["FINISHED"] == 18 * 3
        out[pkg] = wq2
    assert str(out[T].device) == "cpu"
    assert_cols_equal(out[T].store, out[R].store, out[T].store.cols)


def test_spawned_replica_loads_neither_torch_nor_the_reference(
        tmp_path, monkeypatch):
    """A replica process, spawned with a ``sitecustomize`` that writes its
    ``sys.modules`` at exit: it served a sync, a sweep and a promote, and
    never imported torch or ``repro``."""
    (tmp_path / "sitecustomize.py").write_text(
        "import atexit, os, sys\n"
        "def _dump():\n"
        "    with open(os.path.join(os.environ['MODULES_DUMP_DIR'],\n"
        "              f'{os.getpid()}.txt'), 'w') as f:\n"
        "        f.write('\\n'.join(k for k, v in sys.modules.items()\n"
        "                           if v is not None))\n"
        "atexit.register(_dump)\n")
    dump = tmp_path / "dump"
    dump.mkdir()
    monkeypatch.setenv("MODULES_DUMP_DIR", str(dump))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path)] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    wq = make_wq(T, 2)
    rep = replication.ShippedDeltaReplicator(wq)
    pid = rep.remote_pid
    wq.add_tasks(0, 6)
    wq.claim_all(k=1, now=1.0)
    rep.sync()
    assert rep.remote_sweep(2.0)["q4"] == 6
    proc = rep.process
    rep.close()
    proc.join(timeout=30)
    assert not proc.is_alive()
    mods = set((dump / f"{pid}.txt").read_text().split("\n"))
    assert "repro_torch.core.replication" in mods
    assert "repro_torch.core.steering" in mods
    assert not {m for m in mods if m == "torch" or m.startswith("torch.")}
    assert not {m for m in mods if m == "repro" or m.startswith("repro.")}
