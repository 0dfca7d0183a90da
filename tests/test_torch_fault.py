"""The port's fault, elastic and straggler runtime, provenance, the
centralized master and ``SteeringEngine.at_version``, against the
reference (``tests/test_core_fault.py``, ``tests/test_core_steering.py``,
``tests/test_replication.py``): the same seeded scripts run through both
packages and give equal results: dead workers and their requeued rows,
speculative clones and their reconcile, elastic resizes, the W3C PROV
document and derivation paths, the centralized master's claims and message
count, and every historical view ``at_version`` rebuilds."""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.configs.risers_workflow import WorkflowConfig as RefWf  # noqa: E402
from repro.core import centralized as ref_centralized  # noqa: E402
from repro.core import provenance as ref_provenance  # noqa: E402
from repro.runtime import elastic as ref_elastic  # noqa: E402
from repro.runtime import fault as ref_fault  # noqa: E402
from repro.runtime import straggler as ref_straggler  # noqa: E402
from repro_torch.configs.risers_workflow import WorkflowConfig  # noqa: E402
from repro_torch.core import centralized, provenance  # noqa: E402
from repro_torch.core.transactions import LogCompactedError  # noqa: E402
from repro_torch.runtime import elastic, fault, straggler  # noqa: E402

PORT = {"core": T, "fault": fault, "elastic": elastic,
        "straggler": straggler, "provenance": provenance,
        "centralized": centralized, "wf": WorkflowConfig}
REF = {"core": R, "fault": ref_fault, "elastic": ref_elastic,
       "straggler": ref_straggler, "provenance": ref_provenance,
       "centralized": ref_centralized, "wf": RefWf}


def sweep_key(res):
    return json.dumps(res, sort_keys=True, default=str)


def make_wq(pkg, workers, **kw):
    if pkg is PORT:
        kw.setdefault("device", "cpu")
    return pkg["core"].WorkQueue(num_workers=workers, **kw)


def both(fn):
    """``fn`` run on the port and the reference: (port, reference)."""
    return fn(PORT), fn(REF)


def cols_equal(a, b):
    return all(np.array_equal(a.col(n), b.col(n), equal_nan=True)
               for n in a.cols)


def test_heartbeat_monitor_requeues_and_resyncs_as_the_reference():
    def run(p):
        wq = make_wq(p, 3)
        wq.add_tasks(0, 9)
        wq.claim(1, k=3, now=0.0)
        mon = p["fault"].HeartbeatMonitor(wq, timeout_s=10.0, now=0.0)
        mon.beat(0, now=100.0)
        mon.beat(2, now=100.0)
        dead = mon.sweep(now=100.0)
        wq.resize(2)
        mon.beat(0, now=101.0)
        mon.beat(1, now=101.0)
        quiet = mon.sweep(now=101.0)
        wq.resize(4)
        grown = mon.sweep(now=105.0)
        mon.beat(0, now=116.0)
        mon.beat(1, now=116.0)
        late = sorted(mon.sweep(now=116.0))
        wq.check_invariants()
        return (dead, quiet, grown, late, sorted(mon.beats)), wq
    (got, wq), (want, rwq) = both(run)
    assert got == want
    assert got[0] == [1] and got[3] == [2, 3]
    assert cols_equal(wq.store, rwq.store)


def test_failure_injector_schedule():
    for p in (PORT, REF):
        inj = p["fault"].FailureInjector().kill_worker_at(3, 1) \
            .crash_supervisor_at(5)
        assert inj.events_at(3) == [(3, "worker", 1)]
        assert inj.events_at(5) == [(5, "supervisor", None)]
        assert inj.events_at(4) == []


@pytest.mark.parametrize("lease_s", [None, 5.0])
def test_speculative_reexec_matches_the_reference(lease_s):
    """A live slow claim is cloned and its clone pruned on reconcile; an
    expired lease is left to the reaper: the same clones and stores."""
    def run(p):
        wq = make_wq(p, 2, lease_s=lease_s)
        wq.add_tasks(0, 10)
        spec = p["straggler"].SpeculativeReexec(wq, percentile=50,
                                                min_samples=5, factor=1.5)
        for t in range(5):
            rows = wq.claim(0, k=1, now=float(t))
            wq.finish(rows, now=float(t) + 1.0)
        slow = wq.claim(1, k=1, now=10.0)
        clones = spec.sweep(now=12.0 if lease_s is None else 20.0)
        if lease_s is None:
            wq.finish(slow, now=101.0)
            out = (len(clones), spec.reconcile(), wq.counts()["PRUNED"])
        else:
            out = (len(clones), wq.reap_expired(now=20.0))
        return out, wq
    (got, wq), (want, rwq) = both(run)
    assert got == want
    assert got[0] == (1 if lease_s is None else 0)
    assert cols_equal(wq.store, rwq.store)


def test_elastic_controller_matches_the_reference():
    def run(p):
        E = p["elastic"]
        out = []
        wq = make_wq(p, 2)
        wq.add_tasks(0, 64)
        out.append(E.ElasticController(
            wq, E.ElasticPolicy(target_tasks_per_worker=8)).maybe_resize())
        wq = make_wq(p, 4)
        wq.add_tasks(0, 40)
        ctl = E.ElasticController(wq, E.ElasticPolicy(
            target_tasks_per_worker=8, hysteresis=0.5))
        out += [ctl.desired_workers(), ctl.maybe_resize()]
        wq = make_wq(p, 4)
        ctl = E.ElasticController(wq, E.ElasticPolicy(
            target_tasks_per_worker=2, min_workers=2, max_workers=6))
        out.append(ctl.desired_workers())
        wq.add_tasks(0, 100)
        out += [ctl.desired_workers(), ctl.maybe_resize()]
        wq = make_wq(p, 1)
        wq.add_tasks(0, 32, status=p["core"].Status.BLOCKED)
        ctl = E.ElasticController(wq, E.ElasticPolicy(
            target_tasks_per_worker=8))
        out += [ctl.desired_workers(), ctl.last_signals["pending"],
                ctl.maybe_resize()]
        wq = make_wq(p, 4)
        wq.add_tasks(0, 32, now=0.0)
        ctl = E.ElasticController(wq, E.ElasticPolicy(
            target_tasks_per_worker=8, max_backlog_age_s=5.0,
            escalation_factor=2.0))
        out += [ctl.maybe_resize(), ctl.maybe_resize(now=2.0),
                ctl.maybe_resize(now=10.0), wq.num_workers]
        wq.check_invariants()
        return out
    got, want = both(run)
    assert got == want
    assert got[0] == 8 and got[-1] == 8


def run_workflow(p, workers=4, tasks=10, activities=4):
    rng = np.random.default_rng(0)
    wf = p["wf"](activities=tuple(f"a{i}" for i in range(activities)))
    wq = make_wq(p, workers)
    sup = p["core"].Supervisor(wq, wf)
    sup.seed(tasks, duration_s=5.0, rng=rng)
    now = 0.0
    for _ in range(200):
        if sup.done():
            break
        for rows in wq.claim_all(k=1, now=now).values():
            if len(rows):
                wq.finish(rows, now=now + 1.0,
                          domain_out=rng.normal(0.6, 0.2, (len(rows), 3)))
        sup.expand(now=now)
        now += 1.0
    return wq


def test_provenance_document_and_derivation_paths_match():
    wq, rwq = both(run_workflow)
    doc = provenance.prov_document(wq)
    assert json.dumps(doc, sort_keys=True) \
        == json.dumps(ref_provenance.prov_document(rwq), sort_keys=True)
    assert set(doc) >= {"activity", "entity", "agent", "used",
                        "wasGeneratedBy", "wasAssociatedWith",
                        "wasDerivedFrom"}
    act = wq.store.col("activity_id")
    for tid in wq.store.col("task_id")[act == 3][:4]:
        path = provenance.derivation_path(wq, int(tid))
        assert len(path) == 4
        assert path == ref_provenance.derivation_path(rwq, int(tid))


def test_centralized_master_matches_the_reference():
    def run(p):
        m = p["centralized"].CentralizedMaster(capacity=64)
        m.add_tasks(0, 12, now=0.0)
        claims = []
        for t in range(8):
            rows = m.claim(t % 3, k=2, now=float(t))
            claims.append(rows.tolist())
            m.finish(rows[:1], now=float(t) + 0.5)
        return claims, m.total_messages, m.store
    (c, n, store), (rc, rn, rstore) = both(run)
    assert c == rc and n == rn == 8 * 5
    assert cols_equal(store, rstore)


def test_at_version_matches_history_and_the_reference():
    """Every historical version, from genesis and from a base snapshot,
    rebuilds the view that was taken then, equal to the reference's
    ``at_version``; future and inverted bounds raise; below a compaction
    horizon genesis replay raises and a checkpoint-style base works."""
    def run(p):
        rng = np.random.default_rng(2)
        wq = make_wq(p, 3)
        steer = p["core"].SteeringEngine(wq)
        wq.add_tasks(0, 30, domain_in=rng.uniform(0, 1, (30, 3)))
        snaps = []
        for r in range(5):
            out = wq.claim_all(k=1, now=float(r))
            rows = np.concatenate([v for v in out.values() if len(v)])
            wq.finish(rows, now=float(r) + 0.5,
                      domain_out=rng.normal(0.5, 0.3, (len(rows), 3)))
            snaps.append(wq.store.snapshot_view())
        views = [steer.at_version(s.version) for s in snaps]
        views.append(steer.at_version(snaps[3].version, base=snaps[0]))
        return wq, steer, snaps, views
    (wq, steer, snaps, views), (_, rsteer, _, rviews) = both(run)
    for s, v, rv in zip(snaps + [snaps[3]], views, rviews):
        assert v.version == rv.version == s.version
        assert sweep_key(steer.run_all(9.0, view=v)) \
            == sweep_key(steer.run_all(9.0, view=s)) \
            == sweep_key(rsteer.run_all(9.0, view=rv))
        for n in wq.store.cols:
            assert np.array_equal(v.col(n), rv.col(n), equal_nan=True), n
    with pytest.raises(ValueError, match="future"):
        steer.at_version(wq.store.version + 1)
    with pytest.raises(ValueError, match="newer"):
        steer.at_version(snaps[0].version, base=snaps[2])
    wq.log.register_consumer("checkpointer", len(wq.log))
    base = wq.store.snapshot_view()
    wq.compact_log()
    assert wq.log.base > 0
    with pytest.raises(LogCompactedError):
        steer.at_version(snaps[1].version)
    wq.claim_all(k=1, now=20.0)
    v = steer.at_version(wq.store.version, base=base)
    assert sweep_key(steer.run_all(30.0, view=v)) \
        == sweep_key(steer.run_all(30.0, view=wq.store.snapshot_view()))
