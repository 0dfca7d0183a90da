"""The traced run: host spans and op entries as ``torch.profiler`` ranges,
and what is read from the profile once it stops.

Spans are the benchmark's own wrappers around the calls into each layer
(``bench::<span>``); each records its wall time and the CPU time of its
own thread (``time.thread_time``), which leaves out the time it waited
for the interpreter lock while another thread held it. An op entry is a wrapper around one of the port's
op functions (``bench::op::<label>``), declared by the kernel files
(:func:`benchlib.cells.op_entries`); the device time of an op is that of
every kernel launched inside its entry, and, for its backward, inside the
autograd node of its Function (``<Function>Backward``), less the entries
nested in them; where the entry names its kernels, only of those. So a
later kernel under the same entry reads the same.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

SPAN = "bench::"
OP = "bench::op::"


class Recorder:
    """Host spans (wall and own-thread CPU seconds) and op-entry shapes
    while ``active``."""

    def __init__(self):
        self.active = False
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.cpu: Dict[str, List[float]] = defaultdict(list)
        self.shapes: Dict[str, List[dict]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        t0, c0 = time.perf_counter(), time.thread_time()
        with torch.profiler.record_function(SPAN + name):
            yield
        self.cpu[name].append(time.thread_time() - c0)
        self.spans[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, fn: Callable) -> Callable:
        def wrapped(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        return wrapped

    def wrap_op(self, name: str, fn: Callable,
                shape_of: Callable[..., dict]) -> Callable:
        def wrapped(*a, **k):
            if not self.active:
                return fn(*a, **k)
            self.shapes[name].append(shape_of(*a, **k))
            with torch.profiler.record_function(OP + name):
                return fn(*a, **k)
        return wrapped


def _device_events(events) -> List:
    """The operations that ran on the card: its kernels, copies and fills,
    not the host's ranges that the profiler mirrors onto its timeline (those
    carry a host event's name)."""
    host = {e.name for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in host]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float,
                                                                float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _own_device_us(e, nested: Callable, kernels=None) -> float:
    """Device us of every kernel under CPU event ``e`` (of those whose name
    holds one of ``kernels``, where given), less that of the events under
    it that ``nested`` names."""
    total = sum(k.duration for k in e.kernels
                if kernels is None or any(f in k.name for f in kernels))
    for ch in e.cpu_children:
        if not nested(ch):
            total += _own_device_us(ch, nested, kernels)
    return total


def read_profile(prof, window_s: float, entries: Dict[str, object]
                 ) -> Dict[str, object]:
    """What the benchmark reads from a stopped profile of ``window_s``
    seconds: the device's busy seconds, the longest idle gaps by the host
    span open in them, the device operations that took most time, and each
    op's device seconds a call (its entry, and its backward node as
    ``<label>.bwd``), of ``entries`` (label -> :class:`cells.OpEntry`)."""
    events = prof.events()
    dev = _device_events(events)
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6

    by_op: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_op[e.name] += e.time_range.elapsed_us() / 1e6
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]

    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    bwd_name = {f"{x.node}Backward": op for op, x in entries.items()
                if x.node}

    def node_op(e) -> Optional[str]:
        for key, op in bwd_name.items():
            if key in e.name and e.name.startswith("autograd::engine"):
                return op
        return None

    def is_entry(e) -> bool:
        return e.name.startswith(OP) or node_op(e) is not None

    op_s: Dict[str, List[float]] = defaultdict(list)
    for e in cpu:
        if e.name.startswith(OP):
            op = key = e.name[len(OP):]
        else:
            op = node_op(e)
            key = f"{op}.bwd"
        if op is None:
            continue
        kern = entries[op].kernels if op in entries else None
        op_s[key].append(_own_device_us(e, is_entry, kern) / 1e6)

    # idle gaps, each put to the innermost span open at its middle on the
    # driving thread (every span but the analyst thread's steering sweep),
    # marked when a sweep ran meanwhile
    spans = [e for e in cpu if e.name.startswith(SPAN)
             and not e.name.startswith(OP)]
    steer = [s for s in spans if s.name == SPAN + "steer"]
    main = [s for s in spans if s.name != SPAN + "steer"]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, a1), (b0, _) in zip(busy, busy[1:]):
        mid = (a1 + b0) / 2

        def open_at(group):
            return [s for s in group
                    if s.time_range.start <= mid <= s.time_range.end]
        inner = open_at(main)
        name = min(inner, key=lambda s: s.time_range.elapsed_us()).name[
            len(SPAN):] if inner else "outside spans"
        if open_at(steer):
            name += " (steer running)"
        gaps[name] += (b0 - a1) / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s,
            "device_ops": [[n, s] for n, s in top_ops],
            "idle_gaps": [[n, s] for n, s in idle],
            "op_device_s": dict(op_s)}
