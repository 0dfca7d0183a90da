"""The port's spans read from a profile (``benchlib/program_trace.py``):
on synthetic events, the idle partition adds up to ``device_idle_pct.train``
exactly, a kernel launched on another thread inside ``step.backward`` is
the backward's, and every span name gets its wall, device and idle seconds;
on a CPU-profiled tiny cell, every traced window holds the port's spans in
``obs["program"]``, a reader of a span the harness never names reads it,
and no device quantity is read; on a port without a tracer, nothing is
read; an untraced run leaves the tracer off."""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import pytest
import torch

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


def _read(name, obs):
    return cells.metric_reader(name)(obs)


def test_idle_partition_adds_up_and_backward_is_found_by_launch():
    events, recs = _synthetic()
    window_s = 600e-6
    obs = read_profile(_Prof(events), window_s, {})
    obs["program"] = program_trace.read_program(_Prof(events), recs)
    p = obs["program"]
    assert p["tasks"] == 2 and p["records"] == recs
    # kernels by the span holding their launching op's start; the backward's
    # op runs on the autograd thread and is no child of the step.backward
    # range; the mirrored range is no kernel; the profiling layer's event
    # that shares the op's id adds nothing
    sp = p["spans"]
    assert {k: sp[k]["device_s"] for k in program_trace.PHASES} == \
        pytest.approx({"step.forward": 40e-6, "step.backward": 50e-6,
                       "step.optimizer": 20e-6})
    # every span name alike: a step holds its phases' kernels; a sweep is
    # only in the records, so it launched nothing the profile saw
    assert sp["tick.step"]["device_s"] == pytest.approx(110e-6)
    assert sp["tick.claim"]["device_s"] == 0.0
    assert sp["steer.sweep"]["device_s"] is None
    assert sp["steer.sweep"]["wall_s"] == pytest.approx([15e-6])
    # each step [t+20, t+100]: busy 20 + 25 + 10 + 2 (the copy's start)
    assert sp["tick.step"]["idle_s"] == pytest.approx(2 * (80 - 57) * 1e-6)
    # the forward [t+21, t+50]: busy 25-45; the sweep [1245, 1260]: busy
    # 1256-1260
    assert sp["step.forward"]["idle_s"] == pytest.approx(2 * 9e-6)
    assert sp["steer.sweep"]["idle_s"] == pytest.approx(11e-6)
    got = {m: _read(m, obs) for m in NEW + ("device_idle_pct.train",)}
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
    assert p["tasks"] == 2 and "task_device_s" not in p
    assert p["spans"]["tick.claim"]["wall_s"] == pytest.approx([1e-5, 1e-5])
    assert all(v["device_s"] is None and v["idle_s"] is None
               for v in p["spans"].values())
    obs = {"busy_s": 0.0, "window_s": 1.0, "program": p}
    got = {m: _read(m, obs) for m in NEW}
    assert got == dict.fromkeys(NEW[:-1], None) | {
        "claim_wall_ms.train": pytest.approx(0.01)}
    # a profile without the port's spans (a port with no tracer)
    bare = [e for e in events if not e.name.startswith(
        program_trace.PREFIX)]
    obs = read_profile(_Prof(bare), 1e-3, {})
    obs["program"] = program_trace.read_program(_Prof(bare), [])
    assert obs["program"] == {"records": [], "spans": {}, "tasks": 0}
    assert program_trace.info(obs) == {}
    assert all(_read(m, obs) is None for m in NEW)


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
    r = sweep.SweepRun(cells.cell("tiny", spec, tmp), 3000000043, "cpu",
                       True)
    r.setup()
    win = r.window(1.0)
    r.close_program()
    obs = win["obs"]
    p = obs["program"]
    assert p["tasks"] == obs["tasks"] >= 1
    claims = p["spans"]["tick.claim"]["wall_s"]
    assert len(claims) >= p["tasks"] / r.mix["workers"]
    assert all(0 < s < 1.0 for s in claims)
    assert "task_device_s" not in p
    assert all(v["device_s"] is None for v in p["spans"].values())
    # the raw records, as the tracer returned them
    assert {x.name for x in p["records"]} >= {"tick.claim", "tick.step",
                                             "step.forward"}
    from repro_torch import trace
    assert not trace.enabled()


def test_the_kernel_files_entries_are_wrapped_each_once(tiny):
    """A traced run wraps every entry the kernel files declare, once each
    (two files share each entry), reads their calls in the window, and
    puts the port's own back when the program closes."""
    from repro_torch.kernels import ops as kops
    tmp, spec = tiny
    declared = {e.op for e in cells.op_entries().values()}
    assert declared == {"flash_attention", "ssd_scan", "cross_entropy"}
    before = {op: getattr(kops, op) for op in declared}
    r = sweep.SweepRun(cells.cell("tiny", spec, tmp), 3000000067, "cpu",
                       True)
    r.setup()
    wrapped = sorted(name for mod, name, _ in r._patched if mod is kops)
    assert wrapped == sorted(declared)
    assert all(getattr(kops, op) is not before[op] for op in declared)
    win = r.window(1.0)
    r.close_program()
    assert all(getattr(kops, op) is before[op] for op in declared)
    # on the CPU the dense cell's attention takes the plain path; its loss
    # goes through the entry: chunks of 4 x 16 tokens, each called in the
    # forward and again in the checkpoint's recompute
    shapes = win["obs"]["shapes"]
    assert set(shapes) == {"xent"}
    assert shapes["xent"][0] == {"rows": 4 * 16, "v": 96,
                                 "dtype": "bfloat16"}
    assert len(shapes["xent"]) == 2 * 2 * win["obs"]["program"]["tasks"]


def test_a_reader_of_a_span_the_harness_never_names_reads_it(tiny,
                                                             tmp_path):
    """A later span needs only a reader file: ``tick.commit`` is named
    nowhere in the harness."""
    tmp, spec = tiny
    path = tmp_path / "commit_wall_ms.train.py"
    path.write_text(
        "from benchlib.program_trace import span\n\n\n"
        "def read(obs):\n"
        "    t = span(obs, 'tick.commit').get('wall_s')\n"
        "    return 1e3 * sum(t) / len(t) if t else None\n")
    r = sweep.SweepRun(cells.cell("tiny", spec, tmp), 3000000059, "cpu",
                       True)
    r.setup()
    win = r.window(1.0)
    r.close_program()
    got = cells._load_file(path, "metric").read(win["obs"])
    assert 0 < got < 1e3
    walls = [x.wall_s for x in win["obs"]["program"]["records"]
             if x.name == "tick.commit"]
    assert got == pytest.approx(1e3 * sum(walls) / len(walls))


def test_split_reports_the_claims_wall_and_no_device_quantity(tiny):
    tmp, spec = tiny
    out = run.run("tiny", 3000000047, 1.0, True, device="cpu",
                  t_start=time.time(), spec=spec, files=tmp)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert got["claim_wall_ms.train"]["value"] >= \
        0.99 * got["claim_ms.train"]["value"]
    assert not set(got) & set(NEW[:-1])
    assert "idle_s_by_program_span" not in out["info"]


def test_the_benchmarks_traced_run_leaves_the_tracer_off(tiny):
    """The tracer is on only in a traced window: an untraced run leaves it
    off and records nothing, a traced one turns it off at the trace's
    end."""
    from repro_torch import trace
    tmp, spec = tiny
    trace.take()
    out = run.run("tiny", 3000000053, 1.0, False, device="cpu",
                  t_start=time.time(), spec=spec, files=tmp)
    assert out["correct"], out["checks"]
    assert not trace.enabled() and trace.take() == []
    run.run("tiny", 3000000061, 1.0, True, device="cpu",
            t_start=time.time(), spec=spec, files=tmp)
    assert not trace.enabled() and trace.take() == []
