"""Readings that the limits of a cell's comparison are set from, in one
process (the benchmark's runs never run this):

    python3 bench/calibrate.py --workload <cell> --seeds 12 --controls 3 \
        --first-seed <n>

For each of ``--seeds`` seeds: the cell's set-up (the program's checked
steps through the timed path, as a run makes them) and the numbers it
compares against the plain reference (the lower readings). For the first
``--controls`` of them also the control, the reference computed with fp8
products in the program's place, and the planted faults, each read against
the same fp32 reference: half of each batch left out (the mean taken over
the rest), and the state left unchanged (which reads 1 by the measure and
is not run). Each of the three is judged as a run judges the program's
steps, against the cell's committed limits of the numbers it reads
(``correct``): the program's has to come out correct, the control's and
the half batch's not. One JSON line per seed, then a summary line with
the range of each number and the count of each kind's verdicts.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))


def readings(cell_name: str, seed: int, controls: bool, device: str,
             spec=None, files=None) -> dict:
    import torch
    from benchlib import cells, checks
    from benchlib.sweep import CHECKED_STEPS, SweepRun, reference_steps
    cell = cells.cell(cell_name, spec, files or cells.BENCH)
    r = SweepRun(cell, seed, device, trace=False)
    r.setup()
    r.close_program()
    t = time.perf_counter()
    limits = cell.limits["limits"]

    def judged(gaps: dict) -> dict:
        ok, _ = checks.verdict(gaps, {k: v for k, v in limits.items()
                                      if k in gaps})
        return dict(gaps, correct=ok)

    out = {"seed": seed, "program": judged(r.check_training()),
           "program_info": r.train_info,
           "losses": [float(x) for x in r.steps[:CHECKED_STEPS]],
           "ref_losses": r.reference_readings["losses"]}
    out["reference_s"] = time.perf_counter() - t
    if controls:
        k = CHECKED_STEPS
        dom = [r.backlog[r.row_pos[f[0]]] for f in r.finished[:k]]
        ref = r.reference_readings
        for name, kw in (("control", {"numerics": "fp8"}),
                         ("half_batch", {"half_batch": True})):
            got = reference_steps(r.ref, r.m, r.spec, seed, device, r.mix,
                                  dom, **kw)
            out[name] = judged(checks.train_gaps(got, ref))
    del r
    for kind in ("control", "half_batch"):
        if kind in out:
            out[kind + "_info"] = {k: out[kind].pop(k) for k in (
                "loss_gap_steps", "grad_worst", "change_worst")}
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--step", type=int, default=7919,
                   help="the distance between two seeds")
    a = p.parse_args(argv)
    rows = []
    for i in range(a.seeds):
        rows.append(readings(a.workload, a.first_seed + a.step * i,
                             i < a.controls, "cuda"))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": a.workload}
    for kind in ("program", "control", "half_batch"):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[kind] = {k: [min(g[k] for g in got),
                                 max(g[k] for g in got)] for k in got[0]
                             if k != "correct"}
            summary[kind]["correct"] = sum(g["correct"] for g in got)
            summary[kind]["runs"] = len(got)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
