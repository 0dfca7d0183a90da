"""Plain answers of the steering sweep (the paper's Table 2 queries Q1 and
Q3-Q7) over one snapshot of the store's columns, written from the queries'
definitions with Python loops over the rows, to hold the program's
answers against.

Status codes as the store's schema defines them (EMPTY 0, BLOCKED 1,
READY 2, RUNNING 3, FINISHED 4, FAILED 5, PRUNED 6).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np

EMPTY, BLOCKED, READY, RUNNING, FINISHED, FAILED, PRUNED = range(7)
HORIZON_S = 60.0
Q7_ACT_A, Q7_ACT_B, Q7_THR = 0, 2, 0.5


def sweep(col: Callable[[str], np.ndarray], num_workers: int,
          now: float) -> Dict[str, object]:
    """The answers of one sweep at ``now`` over the columns ``col(name)``."""
    st = col("status").tolist()
    wid = col("worker_id").tolist()
    t0 = col("start_time").tolist()
    t1 = col("end_time").tolist()
    act = col("activity_id").tolist()
    fails = col("fail_trials").tolist()
    n = len(st)
    open_st = (READY, RUNNING, BLOCKED)

    # Q1: per worker, tasks started in the horizon, finished, failures
    q1: Dict[int, Dict[str, int]] = {}
    for r in range(n):
        if st[r] != EMPTY and t0[r] >= now - HORIZON_S:
            e = q1.setdefault(int(wid[r]), {"started": 0, "finished": 0,
                                            "failures": 0})
            e["started"] += 1
            e["finished"] += st[r] == FINISHED
            e["failures"] += int(fails[r])
    q1 = dict(sorted(q1.items()))
    # Q3: workers with the most tasks failed in the horizon
    per: Dict[int, int] = {}
    for r in range(n):
        if st[r] == FAILED and t1[r] >= now - HORIZON_S:
            per[int(wid[r])] = per.get(int(wid[r]), 0) + 1
    q3: List[int] = sorted(w for w, c in per.items()
                           if c == max(per.values())) if per else []
    # Q4 and Q5: open tasks, and the activity with the most of them
    opened = [r for r in range(n) if st[r] in open_st]
    q4 = len(opened)
    by_act: Dict[int, int] = {}
    for r in opened:
        by_act[int(act[r])] = by_act.get(int(act[r]), 0) + 1
    q5 = (min(a for a, c in by_act.items() if c == max(by_act.values())),
          max(by_act.values())) if by_act else (-1, 0)
    # Q6: mean and max task time of each activity that is still open
    still = {int(act[r]) for r in range(n) if st[r] in (READY, RUNNING)}
    durs: Dict[int, List[float]] = {}
    for r in range(n):
        if st[r] == FINISHED and int(act[r]) in still:
            durs.setdefault(int(act[r]), []).append(t1[r] - t0[r])
    q6 = {a: (math.fsum(d) / len(d), max(d)) for a, d in durs.items()}
    # Q7: this store's sweeps run one activity (0), so no task of
    # activity 2 exists and the provenance join finds nothing
    if any(st[r] == FINISHED and act[r] == Q7_ACT_B for r in range(n)):
        raise NotImplementedError("Q7 with activity-2 tasks")
    return {"q1": q1, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q7": []}


def mismatches(got: Dict[str, object], want: Dict[str, object],
               rel: float) -> List[str]:
    """The queries whose answers differ: exact, but the means and maxima of
    Q6, held to ``rel`` of their value (the program sums in another
    order)."""
    bad = []
    for q in ("q1", "q3", "q4", "q7"):
        g = got.get(q)
        g = {int(k): dict(v) for k, v in g.items()} if q == "q1" else \
            (list(g) if isinstance(g, (list, tuple)) else g)
        if g != want[q]:
            bad.append(q)
    if tuple(got.get("q5", ())) != tuple(want["q5"]):
        bad.append("q5")
    g6 = {int(k): tuple(v) for k, v in dict(got.get("q6", {})).items()}
    if set(g6) != set(want["q6"]) or any(
            abs(g6[a][i] - want["q6"][a][i])
            > rel * max(abs(want["q6"][a][i]), 1e-300)
            for a in want["q6"] for i in (0, 1)):
        bad.append("q6")
    return bad
