"""Spans inside the port: what the host was doing in a train tick, a train
step and a steering sweep.

    from repro_torch import trace
    with trace.span("tick.claim"):
        ...

The switch is process-wide, a module flag and not a context variable, so
the steering analyst thread and the autograd engine's device thread see
what the driving thread set. It starts at ``flags.TRACE`` (the REPRO_TRACE
env var, off unless set) and :func:`enable` flips it.

Off, :func:`span` returns one shared no-op context: a single flag check, no
profiler range and no clock read. On, a span is a
``torch.profiler.record_function("repro_torch::<name>")`` range, so that a
profile puts it on the clock of the CUDA kernels it launched, and when it
closes it appends a :class:`Span` (its name, its thread's name, its
``time.perf_counter`` start and end) that :func:`take` returns and clears:
spans can be read without a profiler. The newest ``KEEP`` are kept.

The spans (``bench/program_split.py`` reads them from a profile):
  tick.claim, tick.batch, tick.step, tick.readback, tick.commit,
  tick.checkpoint, tick.steer_submit   ``TrainExecutor.tick``, driving thread
  step.forward, step.backward (one each a microbatch), step.optimizer
                                       the train step, ``launch/steps.py``
  steer.sweep                          ``SteeringEngine.run_all``, analyst
                                       thread
torch is imported only when a span opens with the tracer on: the replica
processes, which import the store and steering, import no torch.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Deque, List, NamedTuple

from repro_torch import flags

PREFIX = "repro_torch::"
KEEP = 100_000


class Span(NamedTuple):
    name: str
    thread: str
    start_s: float      # time.perf_counter()
    end_s: float

    @property
    def wall_s(self) -> float:
        return self.end_s - self.start_s


_on = flags.TRACE
_records: Deque[Span] = collections.deque(maxlen=KEEP)
_lock = threading.Lock()
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Turn the spans on or off, in every thread of the process."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def take() -> List[Span]:
    """The spans closed since the last call, in the order they closed; the
    tracer keeps none of them."""
    with _lock:
        out = list(_records)
        _records.clear()
    return out


class _Range:
    """One span while the tracer is on."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Range":
        from torch.profiler import record_function
        self._rf = record_function(PREFIX + self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self._rf.__exit__(*exc)
        rec = Span(self.name, threading.current_thread().name, self._t0, t1)
        with _lock:
            _records.append(rec)
        return False


def span(name: str):
    """A context around the work ``name`` names (the module's docstring
    lists them): the shared no-op context while the tracer is off."""
    if not _on:
        return _OFF
    return _Range(name)
