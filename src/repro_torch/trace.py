"""Spans and counters inside the port: what the host was doing in a train
tick, a train step, an MoE layer and a steering sweep, and what an MoE
layer's router chose.

    from repro_torch import trace
    with trace.span("tick.claim"):
        ...
    trace.count("moe.expert_load", counts)     # a tensor on the card

The switch is process-wide, a module flag and not a context variable, so
the steering analyst thread and the autograd engine's device thread see
what the driving thread set. It starts at ``flags.TRACE`` (the REPRO_TRACE
env var, off unless set) and :func:`enable` flips it.

Off, :func:`span` returns one shared no-op context and :func:`count`
returns at once: a single flag check, no profiler range, no clock read,
nothing launched and nothing kept. On, a span is a
``torch.profiler.record_function("repro_torch::<name>")`` range, so that a
profile puts it on the clock of the CUDA kernels it launched, and when it
closes it appends a :class:`Span` (its name, its thread's name, its
``time.perf_counter`` start and end) that :func:`take` returns and clears:
spans can be read without a profiler. A counter appends a
:class:`Counter`, a span of no length that also holds the tensor it was
given, as it is on its device: :func:`take` reads every counter's values
to the host in one copy, so the layers add no host sync. The newest
``KEEP`` records are kept.

The spans and counters (``bench/benchlib/program_trace.py::read_program``
reads them, from a profile and from :func:`take`):
  tick.claim, tick.batch, tick.step, tick.readback, tick.commit,
  tick.checkpoint, tick.steer_submit   ``TrainExecutor.tick``, driving thread
  step.forward, step.backward (one each a microbatch), step.optimizer
                                       the train step, ``launch/steps.py``
  moe.route, moe.dispatch, moe.experts, moe.combine
                                       the dropless MoE layer
                                       (``models/moe.py``), one each a
                                       layer and forward, again in remat's
                                       recompute
  moe.expert_load (counter)            that layer's [E] assignments by
                                       expert, one a layer and forward
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
from typing import Any, Deque, List, NamedTuple, Union

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


class Counter(NamedTuple):
    """A counter's record: a :class:`Span`'s fields (it starts and ends at
    the same time) and ``value``, the counted tensor while the tracer holds
    it, its values as a list of floats once :func:`take` returns it."""
    name: str
    thread: str
    start_s: float
    end_s: float
    value: Any

    @property
    def wall_s(self) -> float:
        return self.end_s - self.start_s


_on = flags.TRACE
_records: Deque[Union[Span, Counter]] = collections.deque(maxlen=KEEP)
_lock = threading.Lock()
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Turn the spans on or off, in every thread of the process."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def take() -> List[Union[Span, Counter]]:
    """The spans closed and counters recorded since the last call, in the
    order they were made; the tracer keeps none of them. The counters'
    tensors are read to the host here, in one copy."""
    with _lock:
        out = list(_records)
        _records.clear()
    held = [i for i, r in enumerate(out) if isinstance(r, Counter)]
    if held:
        import torch
        vals = [out[i].value.detach().reshape(-1).float() for i in held]
        flat = torch.cat([v.to(vals[0].device) for v in vals]).tolist()
        at = 0
        for i, v in zip(held, vals):
            out[i] = out[i]._replace(value=flat[at:at + v.numel()])
            at += v.numel()
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


def count(name: str, value) -> None:
    """Record the tensor ``value`` under ``name`` (the module's docstring
    lists the counters), as it is: nothing is launched or copied until
    :func:`take`. Nothing at all while the tracer is off."""
    if not _on:
        return
    t = time.perf_counter()
    rec = Counter(name, threading.current_thread().name, t, t, value.detach())
    with _lock:
        _records.append(rec)
