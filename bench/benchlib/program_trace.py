"""The port's own spans in a traced run: its tracer switched on for the
traced window, and what is read of its ``repro_torch::<span>`` ranges from
the profile that :func:`benchlib.trace.read_profile` reads.

The benchmark's cells do not read them yet: :class:`ProgramRun` is the
``sweep`` kind's run with the tracer on for the traced window, and
``bench/program_split.py`` runs a cell with it and prints the split
(:func:`info`) and the six quantities of :func:`metrics`.

The spans (``repro_torch.trace``): ``tick.*`` on the driving thread, around
each part of ``TrainExecutor.tick``; ``step.forward`` / ``step.backward``
(one each a microbatch) and ``step.optimizer`` inside ``tick.step``;
``steer.sweep`` on the analyst thread. The profiler records the ranges of
the threads it follows, the driving thread and the autograd engine's, and
not the analyst thread's, so a sweep's interval comes from the tracer's own
records (``time.perf_counter``), put on the profile's clock by the offset
that the driving thread's spans, found in both, give.

A kernel belongs to the phase span (forward, backward, optimizer) whose
interval holds the start of the host op that launched it, on whichever
thread that op ran: a CUDA backward is launched from the autograd engine's
thread, so its kernels are not under the ``step.backward`` range in the
event tree.

A checkout whose port has no tracer reads nothing here: :func:`switch`
does nothing, :func:`read_program` finds no span and returns ``{}``, and
:func:`metrics` gives ``None`` for each quantity.
"""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from benchlib.sweep import SweepRun
from benchlib.trace import _device_events, _union

PREFIX = "repro_torch::"
STEP, READBACK, CLAIM = "tick.step", "tick.readback", "tick.claim"
PHASES = ("step.forward", "step.backward", "step.optimizer")
STEER = "steer.sweep"

Interval = Tuple[float, float]


def switch(on: bool) -> list:
    """Turn the port's tracer on or off; returns the spans it closed since
    the last switch (none where the port has no tracer)."""
    try:
        from repro_torch import trace
    except ImportError:
        return []
    trace.enable(on)
    return trace.take()


def _inside(starts: List[float], ivs: List[Interval], t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ivs[i][1]


def _overlap(a: List[Interval], b: List[Interval]) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _clock_offset_us(spans, records) -> Optional[float]:
    """Profile us minus the tracer's perf_counter in us: the median over
    the driving thread's spans, paired by name and order."""
    prof, rec = defaultdict(list), defaultdict(list)
    for e in spans:
        prof[e.name[len(PREFIX):]].append(e.time_range.start)
    for r in records:
        if r.name != STEER:
            rec[r.name].append(r.start_s * 1e6)
    diffs = [p - r for n in prof for p, r in zip(sorted(prof[n]),
                                                 sorted(rec.get(n, [])))]
    return statistics.median(diffs) if diffs else None


def read_program(prof, records: Sequence) -> Dict:
    """What the benchmark reads of the port's spans in a stopped profile,
    ``records`` being the tracer's own of the same window. Of each event
    it reads ``name``, ``device_type``, ``time_range``, and of a host
    event ``id`` and ``kernels``."""
    events = prof.events()
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    spans = sorted((e for e in cpu if e.name.startswith(PREFIX)),
                   key=lambda e: e.time_range.start)
    if not spans:
        return {}

    def ivs(name: str) -> List[Interval]:
        return [(e.time_range.start, e.time_range.end) for e in spans
                if e.name == PREFIX + name]

    steps, readbacks = ivs(STEP), ivs(READBACK)
    out = {"tasks": len(steps),
           "claim_wall_s": [r.wall_s for r in records if r.name == CLAIM],
           "steer_wall_s": [r.wall_s for r in records if r.name == STEER]}
    dev = _device_events(events)
    if not dev:
        return out
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])

    # the card's idle time while a step is open (tick.step spans do not
    # overlap: one driving thread)
    step_busy = _overlap(steps, busy)
    out["step_idle_s"] = (sum(b - a for a, b in steps) - step_busy) / 1e6

    # device seconds by the phase whose span holds each launching op's
    # start. The profiler hands an op's kernels to every host event of its
    # correlation id, the CUDA profiling layer's own ("Command Buffer Full",
    # "Activity Buffer Request") among them, inside the op: counted once,
    # at the first of them
    host = {e.name for e in cpu}
    phase_ivs = {p: ivs(p) for p in PHASES}
    phase_starts = {p: [a for a, _ in v] for p, v in phase_ivs.items()}
    phase_us = dict.fromkeys(PHASES, 0.0)
    seen = set()
    for e in sorted(cpu, key=lambda e: e.time_range.start):
        us = sum(k.duration for k in e.kernels if k.name not in host)
        if not us or e.id in seen:
            continue
        seen.add(e.id)
        t = e.time_range.start
        for p in PHASES:
            if _inside(phase_starts[p], phase_ivs[p], t):
                phase_us[p] += us
                break
    out["phase_device_s"] = {p: us / 1e6 for p, us in phase_us.items()}

    # the card's seconds over the same tasks, from each step's start to
    # the end of the readback after it, which drains the card: summed over
    # the operations, as the phases are
    rb_starts = [a for a, _ in readbacks]
    tasks = []
    for a, b in steps:
        i = bisect.bisect_left(rb_starts, b)
        tasks.append((a, readbacks[i][1] if i < len(readbacks) else b))
    task_starts = [a for a, _ in tasks]
    out["task_device_s"] = sum(
        e.time_range.elapsed_us() for e in dev
        if _inside(task_starts, tasks, e.time_range.start)) / 1e6

    out["idle_s_by_span"] = _idle_by_span(spans, busy, records)
    return out


def _idle_by_span(spans, busy: List[Interval], records
                  ) -> Dict[str, float]:
    """Idle seconds between the card's busy intervals, each gap put to the
    innermost driving-thread span open at its middle, marked when a
    steering sweep was open then."""
    main = [s for s in spans if s.name != PREFIX + STEER]
    off = _clock_offset_us(main, records)
    steer = sorted((r.start_s * 1e6 + off, r.end_s * 1e6 + off)
                   for r in records if r.name == STEER) \
        if off is not None else []
    steer_starts = [a for a, _ in steer]
    starts = [s.time_range.start for s in main]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, a1), (b0, _) in zip(busy, busy[1:]):
        mid = (a1 + b0) / 2
        # one thread's spans nest: the innermost open at ``mid`` is the
        # latest-starting span that has not closed by then
        name = "outside spans"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if main[i].time_range.end >= mid:
                name = main[i].name[len(PREFIX):]
                break
        if any(a <= mid <= b for a, b in steer[
                :bisect.bisect_right(steer_starts, mid)]):
            name += " (steer running)"
        gaps[name] += (b0 - a1) / 1e6
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


def info(obs) -> Dict[str, object]:
    """The result's ``info`` of a traced window: the idle seconds by the
    port's span; the device ms a task by phase; the share of the tasks'
    device seconds that the three phases account for; the mean wall ms of
    a sweep inside the port's ``steer.sweep``."""
    p = (obs or {}).get("program") or {}
    if "idle_s_by_span" not in p:
        return {}
    ph, steer = p["phase_device_s"], p["steer_wall_s"]
    return {"idle_s_by_program_span": p["idle_s_by_span"],
            "device_ms_by_phase": {k: 1e3 * v / p["tasks"]
                                   for k, v in ph.items()}
            if p["tasks"] else {},
            "phase_cover_pct": 100.0 * sum(ph.values()) / p["task_device_s"]
            if p["task_device_s"] else None,
            "steer_span_wall_ms": 1e3 * sum(steer) / len(steer)
            if steer else None}


def metrics(obs) -> Dict[str, Optional[float]]:
    """Of a traced window: the card's idle share of the window while
    ``tick.step`` is open and outside it (the two add up to
    ``device_idle_pct.train``), the device ms a task of each phase, and the
    mean wall ms of ``tick.claim`` (lock wait included); ``None`` where
    nothing was read."""
    p = (obs or {}).get("program") or {}
    w, busy = obs["window_s"], obs["busy_s"]
    step = p.get("step_idle_s") if w and busy else None
    ph = p.get("phase_device_s") if p.get("tasks") else None
    claim = p.get("claim_wall_s")
    out = {"step_idle_pct.train": None if step is None else 100.0 * step / w,
           "between_steps_idle_pct.train":
           None if step is None else 100.0 * (w - busy - step) / w,
           "claim_wall_ms.train": 1e3 * sum(claim) / len(claim)
           if claim else None}
    for phase in PHASES:
        out[phase[len("step."):] + "_device_ms.train"] = \
            None if ph is None else 1e3 * ph[phase] / p["tasks"]
    return out


class ProgramRun(SweepRun):
    """The ``sweep`` kind's run with the port's tracer on for the traced
    window: ``obs["program"]`` holds what :func:`read_program` reads, and
    ``info`` adds :func:`info` and :func:`metrics`."""

    _prof = None
    _records: list = []

    def window(self, seconds: float) -> Dict:
        if self.trace:
            switch(True)
        win = super().window(seconds)
        if "obs" in win:
            win["obs"]["program"] = read_program(self._prof, self._records)
            self._prof, self._records = None, []
        return win

    def _stop_trace(self, prof) -> float:
        self._records, self._prof = switch(False), prof
        return super()._stop_trace(prof)

    def info(self, win) -> Dict:
        obs = win.get("obs")
        if obs is None:
            return super().info(win)
        return {**super().info(win), **info(obs), **metrics(obs)}
