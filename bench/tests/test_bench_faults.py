"""A run of the real harness on the CPU, past its look for a card, at a
size a test run holds: sound, it comes out correct; with the program's
timed path broken underneath it comes out not correct, once for each
fault a sweep cell can have: a step that leaves the state unchanged, half
of the batch left out with the mean over the rest, a loss altered where
the step produces it, a steering answer altered where the sweep produces
it, a finish missing from the snapshot the sweep reads. A sweep cell runs
on one chip, so it has no exchange between chips to leave out. Also: a
traced run reads its spans, and the calibration's control and half batch
come out not correct against the limits where the program's steps come
out correct."""
from __future__ import annotations

import time

import numpy as np
import pytest

import calibrate
import run
from tinycell import tiny_cell

# The tiny cell's limits: its sound runs' readings on the CPU (loss ~1e-5,
# grad ~5e-3, change ~2e-2 over seeds) with room, as a cell's limits are
# set from its own.
TINY_LIMITS = {"loss_gap": 5e-4, "grad_gap": 0.03, "change_gap": 0.1}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny")
    return tmp, tiny_cell(tmp, "dense", limits=TINY_LIMITS)


def _run(tiny):
    tmp, spec = tiny
    return run.run("tiny", 3000000019, 1.0, False, device="cpu",
                   t_start=time.time(), spec=spec, files=tmp)


def test_sound_run_is_correct(tiny):
    out = _run(tiny)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _frozen(mp):
    from repro_torch.launch import steps

    def no_update(cfg, params, grads, state, lr, gscale=1.0):
        return params, state, {}
    mp.setattr(steps, "apply_updates", no_update)


def _half_batch(mp):
    from repro_torch.runtime import executor
    whole = executor.batch_for

    def half(cfg, data_cfg, shard):
        b = whole(cfg, data_cfg, shard)
        return {k: v[: len(v) // 2] for k, v in b.items()}
    mp.setattr(executor, "batch_for", half)


def _loss_altered(mp):
    from repro_torch.launch import steps
    inner = steps.loss_and_grads

    def altered(*a, **k):
        loss, metrics, grads = inner(*a, **k)
        return loss * 1.01, metrics, grads
    mp.setattr(steps, "loss_and_grads", altered)


def _steer_altered(mp):
    from repro_torch.core.steering import SteeringEngine
    inner = SteeringEngine.q4_tasks_left
    mp.setattr(SteeringEngine, "q4_tasks_left",
               lambda self: inner(self) + 1)


def _snapshot_altered(mp):
    from repro_torch.core import store
    inner = store.ColumnStore.snapshot_view

    def altered(self):
        v = inner(self)
        cols = dict(v._cols)
        st = cols["status"][:v.n_rows].copy()
        st[np.flatnonzero(st == 4)[-1]] = 2        # a FINISHED row READY
        cols["status"] = st
        return store.SnapshotView(cols, v.n_rows, v.version,
                                  lease_s=v.lease_s)
    mp.setattr(store.ColumnStore, "snapshot_view", altered)


@pytest.mark.parametrize("fault", [_frozen, _half_batch, _loss_altered,
                                   _steer_altered, _snapshot_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_run_is_not_correct(tiny, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(tiny)
    assert not out["correct"], out["checks"]


def test_traced_run_reads_spans_by_their_threads_cpu_time(tiny):
    tmp, spec = tiny
    out = run.run("tiny", 3000000037, 1.0, True, device="cpu",
                  t_start=time.time(), spec=spec, files=tmp)
    assert out["correct"], out["checks"]
    got, info = out["metrics"], out["info"]
    for span, metric in (("claim", "claim_ms.train"),
                         ("steer", "steer_sweep_ms.train")):
        assert 0 < got[metric]["value"] <= info[f"{span}_wall_ms"] * 1.01
        assert info[f"{span}_lock_wait_ms"] == pytest.approx(
            info[f"{span}_wall_ms"] - got[metric]["value"], abs=1e-6)


def test_calibration_judges_control_and_half_batch(tiny):
    tmp, spec = tiny
    got = calibrate.readings("tiny", 3000000041, True, "cpu", spec, tmp)
    assert got["program"]["correct"]
    assert not got["half_batch"]["correct"]
    assert isinstance(got["control"]["correct"], bool)
