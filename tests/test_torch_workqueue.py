"""The port's work queue and steering engine against the reference's, fed
the same operations: claim dicts, store columns, steering sweeps and the
torch device monitor must be equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.steering import SteeringEngine as JaxSteering  # noqa: E402
from repro.core.workqueue import WorkQueue as JaxWorkQueue  # noqa: E402
from repro_torch.core import SteeringEngine, WorkQueue  # noqa: E402
from repro_torch.core.schema import Status  # noqa: E402
from repro_torch.flags import device_claims, wq_device_claim  # noqa: E402


def _script(wq, k_rounds=(1, 4, 1, 4)):
    """A deterministic sequence of queue operations; dyadic times keep float
    columns exact. Returns every claim dict in order."""
    claims = []
    wq.add_tasks(0, 40, domain_in=np.arange(120, dtype=np.float64)
                 .reshape(40, 3) / 8, now=0.0)
    wq.add_tasks(2, 25, duration_est=0.5, now=0.25)
    for r, k in enumerate(k_rounds):
        now = 1.0 + r
        out = wq.claim_all(k=k, now=now)
        claims.append(out)
        rows = np.sort(np.concatenate([v for v in out.values()]))
        if r == 0:
            wq.fail(rows[::3], now=now + 0.5)
            wq.finish(np.setdiff1d(rows, rows[::3]), now=now + 0.5,
                      domain_out=np.full((len(rows) - len(rows[::3]), 3),
                                         0.75))
        elif r == 1:
            wq.requeue_worker(2)
        else:
            wq.finish(rows, now=now + 0.25,
                      domain_out=np.resize([0.25, 1.0], len(rows))[:, None]
                      * np.ones((1, 3)))
    return claims


def _assert_claims_equal(a, b):
    assert a.keys() == b.keys()
    for w in a:
        assert np.array_equal(a[w], b[w]), w


@pytest.mark.parametrize("steal", [True, False])
def test_device_claim_queue_matches_reference_queue(steal):
    port = WorkQueue(num_workers=5, device_claim=True, device="cpu")
    ref = JaxWorkQueue(num_workers=5, device_claim=True)
    if not steal:
        port.claim_all = lambda k, now, _f=port.claim_all: _f(k, now=now,
                                                              steal=False)
        ref.claim_all = lambda k, now, _f=ref.claim_all: _f(k, now=now,
                                                            steal=False)
    for a, b in zip(_script(port), _script(ref)):
        _assert_claims_equal(a, b)
    assert port.store.n_rows == ref.store.n_rows
    for name in port.store.cols:
        assert np.array_equal(port.store.col(name), ref.store.col(name),
                              equal_nan=True), name
    port.check_invariants()
    now = 8.0
    assert SteeringEngine(port).run_all(now) == JaxSteering(ref).run_all(now)


@pytest.mark.parametrize("k", [1, 4])
def test_claim_all_equals_claim_all_reference(k):
    """Device claim (plain version on the CPU) == the seed O(n*W) loop."""
    a = WorkQueue(num_workers=4, device_claim=True, device="cpu")
    b = WorkQueue(num_workers=4, device="cpu")
    for q in (a, b):
        q.add_tasks(0, 37)
        q.add_tasks(1, 11, now=1.0)
    for r in range(4):
        _assert_claims_equal(a.claim_all(k=k, now=float(r)),
                             b.claim_all_reference(k=k, now=float(r)))
    assert np.array_equal(a.store.col("status"), b.store.col("status"))


def test_device_monitor_matches_reference():
    port = WorkQueue(num_workers=3, device="cpu")
    ref = JaxWorkQueue(num_workers=3)
    for q in (port, ref):
        _script(q, k_rounds=(2, 1))
    view_p, view_r = port.store.snapshot_view(), ref.store.snapshot_view()
    eng_p, eng_r = SteeringEngine(port), JaxSteering(ref)
    with eng_p.snapshot_scope(view_p), eng_r.snapshot_scope(view_r):
        got, want = eng_p.device_monitor(), eng_r.device_monitor()
    assert got == want
    assert got["finished"] > 0 and got["running"] > 0


def test_device_flag_and_cuda_default_without_card():
    assert not wq_device_claim()
    with device_claims():
        q = WorkQueue(num_workers=2, device="cpu")
        assert q.device_claim
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            WorkQueue(num_workers=2, device_claim=True)
    host = WorkQueue(num_workers=2)           # host claims need no card
    host.add_tasks(0, 4)
    assert sum(len(v) for v in host.claim_all(k=1).values()) == 2
    assert host.counts()[Status.RUNNING.name] == 2
