"""The port's own spans in a traced run: its tracer switched on for the
traced window (:func:`switch`), and what is read of its
``repro_torch::<span>`` ranges from the profile that
:func:`benchlib.trace.read_profile` reads (:func:`read_program`, kept in
``obs["program"]``).

Every span name the port recorded is read alike, so a reader in
``bench/metrics/`` of a span the port adds later needs no change here:
its wall seconds (the tracer's own records), the device seconds of the
kernels launched inside it and the card's idle seconds while it is open.

The spans (``repro_torch.trace``): ``tick.*`` on the driving thread, around
each part of ``TrainExecutor.tick``; ``step.forward`` / ``step.backward``
(one each a microbatch) and ``step.optimizer`` inside ``tick.step``;
``steer.sweep`` on the analyst thread. The profiler records the ranges of
the threads it follows, the driving thread and the autograd engine's, and
not the analyst thread's, so the interval of a span found only in the
tracer's records comes from those (``time.perf_counter``), put on the
profile's clock by the offset that the spans found in both give.

A kernel belongs to each span whose interval holds the start of the host
op that launched it, on whichever thread that op ran: a CUDA backward is
launched from the autograd engine's thread, so its kernels are not under
the ``step.backward`` range in the event tree. A span found only in the
records launches nothing the profile sees: its device seconds are None.

A checkout whose port has no tracer reads nothing here: :func:`switch`
does nothing and :func:`read_program` finds no span.
"""
from __future__ import annotations

import bisect
import itertools
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from benchlib.trace import _device_events, _union

PREFIX = "repro_torch::"
STEP, READBACK = "tick.step", "tick.readback"
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
    the profile's spans, paired with the records by name and order."""
    prof, rec = defaultdict(list), defaultdict(list)
    for e in spans:
        prof[e.name[len(PREFIX):]].append(e.time_range.start)
    for r in records:
        rec[r.name].append(r.start_s * 1e6)
    diffs = [p - r for n in prof for p, r in zip(sorted(prof[n]),
                                                 sorted(rec.get(n, [])))]
    return statistics.median(diffs) if diffs else None


def _launches(cpu) -> List[Tuple[float, float]]:
    """(start us, device us) of each host op that launched kernels. The
    profiler hands an op's kernels to every host event of its correlation
    id, the CUDA profiling layer's own ("Command Buffer Full", "Activity
    Buffer Request") among them, inside the op: counted once, at the first
    of them. A range mirrored onto the device's timeline carries a host
    event's name and is no kernel."""
    host = {e.name for e in cpu}
    out, seen = [], set()
    for e in sorted(cpu, key=lambda e: e.time_range.start):
        us = sum(k.duration for k in e.kernels if k.name not in host)
        if not us or e.id in seen:
            continue
        seen.add(e.id)
        out.append((e.time_range.start, us))
    return out


def read_program(prof, records: Sequence) -> Dict:
    """What the benchmark reads of the port's spans in a stopped profile,
    ``records`` being the tracer's own of the same window (kept whole
    under ``records``). ``spans`` holds, for every span name found in the
    profile or the records: ``wall_s``, each record's wall seconds;
    ``device_s``, the device seconds of the kernels launched inside it
    (None for a span only in the records); ``idle_s``, the card's idle
    seconds while it is open (None without device events or an
    interval). ``tasks`` counts the profile's ``tick.step`` spans. Of each
    event it reads ``name``, ``device_type``, ``time_range``, and of a host
    event ``id`` and ``kernels``."""
    events = prof.events()
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    spans = sorted((e for e in cpu if e.name.startswith(PREFIX)),
                   key=lambda e: e.time_range.start)
    walls: Dict[str, List[float]] = defaultdict(list)
    for r in records:
        walls[r.name].append(r.wall_s)
    ivs: Dict[str, List[Interval]] = defaultdict(list)
    for e in spans:
        ivs[e.name[len(PREFIX):]].append((e.time_range.start,
                                          e.time_range.end))
    off = _clock_offset_us(spans, records)
    in_profile = set(ivs)
    for r in records:
        if r.name not in in_profile and off is not None:
            ivs[r.name].append((r.start_s * 1e6 + off, r.end_s * 1e6 + off))

    dev = _device_events(events)
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    launches = _launches(cpu) if dev else []
    t_launch = [t for t, _ in launches]
    cum = [0.0, *itertools.accumulate(us for _, us in launches)]
    out_spans = {}
    for name in sorted(set(walls) | set(ivs)):
        u = _union(ivs.get(name, []))
        device = sum(cum[bisect.bisect_right(t_launch, b)]
                     - cum[bisect.bisect_left(t_launch, a)]
                     for a, b in u) / 1e6 \
            if dev and name in in_profile else None
        idle = (sum(b - a for a, b in u) - _overlap(u, busy)) / 1e6 \
            if dev and u else None
        out_spans[name] = {"wall_s": walls.get(name, []),
                           "device_s": device, "idle_s": idle}
    out = {"records": list(records), "spans": out_spans,
           "tasks": len(ivs[STEP]) if STEP in in_profile else 0}
    if not dev or not out["tasks"]:
        return out

    # the card's seconds over the tasks, from each step's start to the end
    # of the readback after it, which drains the card: summed over the
    # operations, as a span's device seconds are
    steps, readbacks = ivs[STEP], ivs.get(READBACK, [])
    rb_starts = [a for a, _ in readbacks]
    tasks = []
    for a, b in steps:
        i = bisect.bisect_left(rb_starts, b)
        tasks.append((a, readbacks[i][1] if i < len(readbacks) else b))
    task_starts = [a for a, _ in tasks]
    out["task_device_s"] = sum(
        e.time_range.elapsed_us() for e in dev
        if _inside(task_starts, tasks, e.time_range.start)) / 1e6
    out["idle_s_by_span"] = _idle_by_span(spans, busy, records, off)
    return out


def _idle_by_span(spans, busy: List[Interval], records, off
                  ) -> Dict[str, float]:
    """Idle seconds between the card's busy intervals, each gap put to the
    innermost driving-thread span open at its middle, marked when a
    steering sweep was open then."""
    main = [s for s in spans if s.name != PREFIX + STEER]
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


def span(obs, name: str) -> Dict:
    """What :func:`read_program` read of span ``name`` in a traced window:
    ``wall_s``, ``device_s``, ``idle_s``; ``{}`` where it never opened."""
    return ((obs or {}).get("program") or {}).get("spans", {}).get(name, {})


def device_ms_a_task(obs, name: str) -> Optional[float]:
    """The device ms of the kernels launched inside span ``name``, a task
    (a ``tick.step`` of the traced window)."""
    tasks = ((obs or {}).get("program") or {}).get("tasks")
    device = span(obs, name).get("device_s")
    return None if not tasks or device is None else 1e3 * device / tasks


def info(obs) -> Dict[str, object]:
    """The result's ``info`` of a traced window: the idle seconds by the
    port's span; the device ms a task by phase; the share of the tasks'
    device seconds that the three phases account for; the mean wall ms of
    a sweep inside the port's ``steer.sweep``."""
    p = (obs or {}).get("program") or {}
    if "idle_s_by_span" not in p:
        return {}
    ph = {k: span(obs, k).get("device_s") or 0.0 for k in PHASES}
    steer = span(obs, STEER).get("wall_s")
    return {"idle_s_by_program_span": p["idle_s_by_span"],
            "device_ms_by_phase": {k: 1e3 * v / p["tasks"]
                                   for k, v in ph.items()}
            if p["tasks"] else {},
            "phase_cover_pct": 100.0 * sum(ph.values()) / p["task_device_s"]
            if p["task_device_s"] else None,
            "steer_span_wall_ms": 1e3 * sum(steer) / len(steer)
            if steer else None}
