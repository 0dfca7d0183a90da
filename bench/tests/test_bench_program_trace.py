"""The port's spans read from a profile (``benchlib/program_trace.py``):
on synthetic events, the idle partition adds up to ``device_idle_pct.train``
exactly and a kernel launched on another thread inside ``step.backward`` is
the backward's; on a CPU-profiled tiny cell, the spans are found and no
device quantity is read; on a port without a tracer, nothing is read; the
benchmark's own run is left as it was."""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import pytest
import torch

import program_split
import run
from benchlib import cells, program_trace, sweep
from benchlib.trace import read_profile
from repro_torch.trace import Span
from tinycell import tiny_cell

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
NEW = ("step_idle_pct.train", "between_steps_idle_pct.train",
       "forward_device_ms.train", "backward_device_ms.train",
       "optimizer_device_ms.train", "claim_wall_ms.train")
OFFSET_US = 5e6         # profile us less the tracer's perf_counter us


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


def _ev(name, start, end, device=CPU, thread=1, kernels=(), id=0):
    return SimpleNamespace(name=name, device_type=device, thread=thread,
                           id=id,
                           time_range=_Range(start, end),
                           kernels=[SimpleNamespace(name=n, duration=d)
                                    for n, d in kernels],
                           cpu_children=[])


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _task(t, steer=False):
    """One task's spans and ops from t us: the forward's kernel launched on
    the driving thread, the backward's on the autograd thread (2), the
    optimizer's on the driving thread; a gap of idle in each phase."""
    P = program_trace.PREFIX
    host = [_ev(P + "tick.claim", t, t + 10), _ev(P + "tick.batch", t + 10,
                                                   t + 20),
            _ev(P + "tick.step", t + 20, t + 100,
                kernels=[(P + "tick.step", 80)]),   # the mirrored range
            _ev(P + "step.forward", t + 21, t + 50),
            _ev(P + "step.backward", t + 50, t + 80),
            _ev(P + "step.optimizer", t + 80, t + 95),
            _ev(P + "tick.readback", t + 100, t + 130),
            _ev(P + "tick.commit", t + 130, t + 140),
            _ev("aten::mm", t + 22, t + 24, kernels=[("gemm", 20)],
                id=t + 1),
            _ev("aten::mm", t + 55, t + 57, thread=2,
                kernels=[("gemm", 25)], id=t + 2),
            # the profiling layer's event inside the op, handed its kernels
            _ev("Command Buffer Full", t + 56, t + 56.5, thread=2,
                kernels=[("gemm", 25)], id=t + 2),
            _ev("aten::_foreach_add_", t + 82, t + 84,
                kernels=[("foreach", 10)], id=t + 3)]
    dev = [_ev("gemm", t + 25, t + 45, CUDA), _ev("gemm", t + 56, t + 81,
                                                  CUDA),
           _ev("foreach", t + 85, t + 95, CUDA),
           _ev("Memcpy DtoH", t + 98, t + 101, CUDA),
           _ev(P + "tick.step", t + 20, t + 100, CUDA)]
    recs = [Span(e.name[len(P):], "MainThread",
                 (e.time_range.start - OFFSET_US) / 1e6,
                 (e.time_range.end - OFFSET_US) / 1e6)
            for e in host if e.name.startswith(P)]
    if steer:       # a sweep open over the forward's and backward's gaps
        recs.append(Span("steer.sweep", "steering_0",
                         (t + 45 - OFFSET_US) / 1e6,
                         (t + 60 - OFFSET_US) / 1e6))
    return host + dev, recs


def _synthetic():
    events, recs = [], []
    for i, t in enumerate((1000.0, 1200.0)):
        e, r = _task(t, steer=i == 1)
        events += e
        recs += r
    return events, recs


def test_idle_partition_adds_up_and_backward_is_found_by_launch():
    events, recs = _synthetic()
    window_s = 600e-6
    obs = read_profile(_Prof(events), window_s, {})
    obs["program"] = program_trace.read_program(_Prof(events), recs)
    p = obs["program"]
    assert p["tasks"] == 2
    # kernels by the phase holding their launching op's start; the backward's
    # op runs on the autograd thread and is no child of the step.backward
    # range; the mirrored range is no kernel; the profiling layer's event
    # that shares the op's id adds nothing
    assert p["phase_device_s"] == pytest.approx(
        {"step.forward": 40e-6, "step.backward": 50e-6,
         "step.optimizer": 20e-6})
    # each step [t+20, t+100]: busy 20 + 25 + 10 + 2 (the copy's start)
    assert p["step_idle_s"] == pytest.approx(2 * (80 - 57) * 1e-6)
    got = program_trace.metrics(obs)
    assert set(got) == set(NEW)
    got["device_idle_pct.train"] = cells.metric_reader(
        "device_idle_pct.train")(obs)
    assert got["step_idle_pct.train"] + got["between_steps_idle_pct.train"] \
        == pytest.approx(got["device_idle_pct.train"], abs=1e-9)
    assert got["step_idle_pct.train"] == pytest.approx(
        100 * 46e-6 / window_s)
    assert got["forward_device_ms.train"] == pytest.approx(0.02)
    assert got["backward_device_ms.train"] == pytest.approx(0.025)
    assert got["optimizer_device_ms.train"] == pytest.approx(0.01)
    assert got["claim_wall_ms.train"] == pytest.approx(0.01)
    # three phases over the tasks' device seconds (the readback's copy
    # counts there, in no phase); a sweep's wall from the tracer's records
    info = program_trace.info(obs)
    assert info["phase_cover_pct"] == pytest.approx(100 * 110 / 116)
    assert info["steer_span_wall_ms"] == pytest.approx(0.015)
    # each gap by the innermost span open at its middle: t+45-56 the
    # backward (the second task's inside its sweep), 81-85 the optimizer,
    # 95-98 the step between its phases, 101-225 no span
    idle = info["idle_s_by_program_span"]
    assert idle == pytest.approx({
        "step.backward": 11e-6, "step.backward (steer running)": 11e-6,
        "step.optimizer": 8e-6, "tick.step": 6e-6, "outside spans": 124e-6})
    assert sum(idle.values()) == pytest.approx(
        (1200 + 101 - 1025) * 1e-6 - obs["busy_s"])


def test_overlapping_kernels_count_alike_in_phases_and_tasks():
    """Two kernels of the forward that overlap on the card by 5 us: each
    phase and the tasks' device seconds sum the operations, so the phases
    still cover the tasks whole."""
    P = program_trace.PREFIX
    events = [_ev(P + "tick.step", 0, 100), _ev(P + "step.forward", 1, 60),
              _ev(P + "tick.readback", 100, 110),
              _ev("aten::mm", 2, 3, kernels=[("gemm", 20)], id=1),
              _ev("aten::add", 4, 5, kernels=[("add", 10)], id=2),
              _ev("gemm", 20, 40, CUDA), _ev("add", 35, 45, CUDA)]
    obs = read_profile(_Prof(events), 200e-6, {})
    obs["program"] = program_trace.read_program(_Prof(events), [])
    assert obs["busy_s"] == pytest.approx(25e-6)
    info = program_trace.info(obs)
    assert info["device_ms_by_phase"]["step.forward"] == pytest.approx(0.03)
    assert info["phase_cover_pct"] == pytest.approx(100.0)
    assert info["steer_span_wall_ms"] is None


def test_without_device_events_or_spans_nothing_is_read():
    events, recs = _synthetic()
    host = [e for e in events if e.device_type == CPU]
    p = program_trace.read_program(_Prof(host), recs)
    assert p == {"tasks": 2, "claim_wall_s": pytest.approx([1e-5, 1e-5]),
                 "steer_wall_s": pytest.approx([1.5e-5])}
    obs = {"busy_s": 0.0, "window_s": 1.0, "program": p}
    got = program_trace.metrics(obs)
    assert got == dict.fromkeys(NEW[:-1], None) | {
        "claim_wall_ms.train": pytest.approx(0.01)}
    # a profile without the port's spans (a port with no tracer)
    bare = [e for e in events if not e.name.startswith(
        program_trace.PREFIX)]
    obs = read_profile(_Prof(bare), 1e-3, {})
    obs["program"] = program_trace.read_program(_Prof(bare), [])
    assert obs["program"] == {} and program_trace.info(obs) == {}
    assert all(v is None for v in program_trace.metrics(obs).values())


def test_a_port_without_a_tracer_switches_nothing(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert program_trace.switch(True) == []
    assert program_trace.switch(False) == []


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny dense cell at the limits ``test_bench_faults.py`` set from
    its sound runs on the CPU."""
    tmp = tmp_path_factory.mktemp("tiny_program")
    return tmp, tiny_cell(tmp, "dense", limits={
        "loss_gap": 5e-4, "grad_gap": 0.03, "change_gap": 0.1})


def test_cpu_profiled_tiny_cell_reads_the_ports_spans(tiny):
    tmp, spec = tiny
    r = program_trace.ProgramRun(cells.cell("tiny", spec, tmp), 3000000043,
                                 "cpu", True)
    r.setup()
    win = r.window(1.0)
    r.close_program()
    obs = win["obs"]
    p = obs["program"]
    assert p["tasks"] == obs["tasks"] >= 1
    assert len(p["claim_wall_s"]) >= p["tasks"] / r.mix["workers"]
    assert all(0 < s < 1.0 for s in p["claim_wall_s"])
    assert "step_idle_s" not in p and "phase_device_s" not in p
    from repro_torch import trace
    assert not trace.enabled()


def test_split_reports_the_claims_wall_and_no_device_quantity(tiny):
    tmp, spec = tiny
    out = program_split.split("tiny", 3000000047, 1.0, device="cpu",
                              t_start=time.time(), spec=spec, files=tmp)
    assert out["correct"], out["checks"]
    info = out["info"]
    assert info["claim_wall_ms.train"] >= \
        0.99 * out["metrics"]["claim_ms.train"]["value"]
    assert all(info[m] is None for m in NEW[:-1])
    assert "idle_s_by_program_span" not in info
    assert sweep.Run is sweep.SweepRun


def test_the_benchmarks_traced_run_leaves_the_tracer_off(tiny):
    from repro_torch import trace
    tmp, spec = tiny
    trace.take()
    out = run.run("tiny", 3000000053, 1.0, True, device="cpu",
                  t_start=time.time(), spec=spec, files=tmp)
    assert out["correct"], out["checks"]
    assert not set(out["metrics"]) & set(NEW)
    assert not set(out["info"]) & set(NEW)
    assert not trace.enabled() and trace.take() == []
