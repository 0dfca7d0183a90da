"""The port's tracer (``repro_torch.trace``) on the CPU: off, a tick records
nothing, opens no profiler range and reads no clock; on, every task gives
one span of each part of the tick and the train step's phases nested in
its step, the analyst thread's sweep is recorded under its thread's name,
and a span closes when the step raises."""
import dataclasses
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.runtime.executor import TrainExecutor  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TICK = ("tick.claim", "tick.batch", "tick.step", "tick.readback",
        "tick.commit")
PHASES = ("step.forward", "step.backward", "step.optimizer")


@pytest.fixture
def tracer():
    """The tracer off and empty; left as it was found."""
    was = trace.enabled()
    trace.enable(False)
    trace.take()
    yield trace
    trace.enable(was)
    trace.take()


def _executor(microbatches=1, **kw):
    cfg = dataclasses.replace(smoke_config("qwen2-0.5b"),
                              microbatches=microbatches)
    ex = TrainExecutor(cfg, num_workers=1, device="cpu",
                       data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=32, batch_size=4), **kw)
    ex.submit_steps(8)
    return ex


def _ticks(ex, n):
    for _ in range(n):
        ex.tick()
    ex._drain_steering()


def _ranges(prof):
    return [e for e in prof.events()
            if e.name.startswith(trace.PREFIX)]


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"the tracer read time.{name} while off")


def test_off_records_nothing_and_opens_no_range(tracer, monkeypatch):
    ex = _executor(steer_every=1)
    with monkeypatch.context() as m:
        m.setattr(trace, "time", _NoClock())
        m.setattr(torch.profiler, "record_function", _NoClock)
        assert trace.span("tick.claim") is trace.span("step.forward")
        _ticks(ex, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _ticks(ex, 2)
    ex.close()
    assert ex.step == 4 and ex.last_steering is not None
    assert _ranges(prof) == []
    assert trace.take() == []


@pytest.mark.parametrize("microbatches", [1, 2])
def test_on_each_task_gives_each_span_once(tracer, microbatches):
    ex = _executor(microbatches)
    _ticks(ex, 1)                  # first calls outside the counted ticks
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _ticks(ex, 3)
    trace.enable(False)
    recs = trace.take()
    ex.close()
    n = Counter(r.name for r in recs)
    assert {k: n[k] for k in TICK} == dict.fromkeys(TICK, 3)
    assert {k: n[k] for k in PHASES} == {
        "step.forward": 3 * microbatches, "step.backward": 3 * microbatches,
        "step.optimizer": 3}
    assert set(n) == set(TICK) | set(PHASES)
    assert {r.thread for r in recs} == {"MainThread"}
    step_ivs = [(r.start_s, r.end_s) for r in recs if r.name == "tick.step"]
    for r in recs:
        assert r.end_s >= r.start_s
        if r.name in PHASES:
            assert sum(a <= r.start_s and r.end_s <= b
                       for a, b in step_ivs) == 1
    # the same spans as profiler ranges, nested the same way
    ranges = _ranges(prof)
    assert Counter(e.name[len(trace.PREFIX):] for e in ranges) == n
    prof_steps = [e.time_range for e in ranges
                  if e.name == trace.PREFIX + "tick.step"]
    for e in ranges:
        if e.name[len(trace.PREFIX):] in PHASES:
            assert sum(s.start <= e.time_range.start
                       and e.time_range.end <= s.end
                       for s in prof_steps) == 1


def test_analyst_sweep_is_recorded_with_its_threads_name(tracer):
    ex = _executor(steer_every=1)
    trace.enable()
    _ticks(ex, 2)
    trace.enable(False)
    ex.close()
    sweeps = [r for r in trace.take() if r.name == "steer.sweep"]
    assert len(sweeps) >= 1
    assert all(r.thread.startswith("steering") and r.wall_s > 0
               for r in sweeps)


def test_span_closes_when_the_step_raises(tracer, monkeypatch):
    ex = _executor()

    class Broken:
        def train_loss(self, params, batch):
            raise RuntimeError("broken loss")

    monkeypatch.setattr(steps, "build_model", lambda cfg: Broken())
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError, match="broken loss"):
            ex.tick()
        with trace.span("after"):
            pass
    trace.enable(False)
    ex.close()
    names = [r.name for r in trace.take()]
    assert names == ["tick.claim", "tick.batch", "step.forward",
                     "tick.step", "after"]
    ranges = {e.name[len(trace.PREFIX):]: e for e in _ranges(prof)}
    assert set(ranges) == set(names)
    step, fwd = ranges["tick.step"].time_range, ranges["step.forward"].time_range
    assert step.start <= fwd.start <= fwd.end <= step.end
    assert ranges["after"].time_range.start >= step.end


def test_take_keeps_the_newest_and_empties(tracer, monkeypatch):
    monkeypatch.setattr(trace, "_records",
                        trace.collections.deque(maxlen=3))
    trace.enable()
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    assert [r.name for r in trace.take()] == ["s2", "s3", "s4"]
    assert trace.take() == []


@pytest.mark.parametrize("value,on", [("", False), ("0", False),
                                      ("1", True), ("yes", True)])
def test_switch_defaults_from_the_environment(value, on):
    env = dict(os.environ, REPRO_TRACE=value,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from repro_torch import trace\n"
         "from repro_torch.core import SteeringEngine, WorkQueue\n"
         "assert 'torch' not in sys.modules\n"
         "print(trace.enabled())"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(on)
