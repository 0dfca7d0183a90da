"""The numbers that decide ``correct``, and their verdict against the
cell's limits.

Training (the program's checked steps against the plain reference's):

  loss_gap    |loss - reference loss| / |reference loss| of the first
              checked step (the later steps' losses swing with AdamW's
              first, sign-like updates, on both sides alike: they are
              reported as ``loss_gap_steps`` and not compared);
  grad_gap    over the leaves, the largest gap between the norm of the
              first gradient as AdamW took it and the reference's, over
              the larger of that leaf's reference norm and the median
              leaf's;
  grad_gap_median  the median over the leaves of the same gap;
  change_gap  the largest such gap of each leaf's change over the checked
              steps, for the leaves whose reference gradient is at least
              ``CHANGE_FLOOR`` of the median leaf's: below it a leaf moves
              under AdamW by round-off alone.

Exact counts (limit 0): ``store_faults`` (a task claimed or finished
twice, finished unclaimed, or whose stored output is not the loss its step
returned) and ``steer_faults`` (a sampled steering answer that differs
from the plain sweep of the same snapshot).
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

CHANGE_FLOOR = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               leaves: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, over the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-300)
            for n in leaves}


def train_gaps(prog: Dict[str, object], ref: Dict[str, object]
               ) -> Dict[str, float]:
    steps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"])]
    names = sorted(ref["grad"])
    if sorted(prog["grad"]) != names or sorted(prog["change"]) != names:
        raise ValueError("the program's leaves differ from the reference's")
    grad = _leaf_gaps(prog["grad"], ref["grad"], names)
    med = statistics.median(ref["grad_raw"].values())
    moving = [n for n in names if ref["grad_raw"][n] >= CHANGE_FLOOR * med]
    change = _leaf_gaps(prog["change"], ref["change"], moving)
    return {"loss_gap": steps[0], "grad_gap": max(grad.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap": max(change.values()),
            "loss_gap_steps": steps,
            "grad_worst": max(grad, key=grad.get),
            "change_worst": max(change, key=change.get)}


def verdict(found: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number the cell's limits name within its limit, each of them
    beside its limit). The cell's limits file names the numbers it
    compares; the others are reported and not compared."""
    table = {k: {"value": found[k], "limit": v} for k, v in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
