"""Run one cell of BENCHMARK.json once, traced, with the port's own spans
on for the traced window, and print the result with what they split.

    python3 bench/program_split.py --workload <cell> --seed <n> \
        --seconds <s>

From the root of a checkout, on the card, as ``bench/run.py --trace 1``
(same set-up, window, check and result line), for a cell of the ``sweep``
kind. Its ``info`` adds, from ``benchlib/program_trace.py``: the idle
seconds by the port's innermost span open (``idle_s_by_program_span``),
the device ms a task by phase and the share of the tasks' device time they
cover, the mean wall ms of a ``steer.sweep``, and the six quantities of
``program_trace.metrics`` (step and between-steps idle shares, forward,
backward and optimizer device ms a task, ``tick.claim``'s wall ms).
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402


def split(cell_name: str, seed: int, seconds: float, device: str = "cuda",
          t_start: float = None, spec=None, files=None) -> dict:
    """``run.run`` of a traced window with :class:`ProgramRun` for the
    ``sweep`` kind's run."""
    from benchlib import program_trace, sweep
    plain = sweep.Run
    sweep.Run = program_trace.ProgramRun
    try:
        return run.run(cell_name, seed, seconds, True, device=device,
                       t_start=T_START if t_start is None else t_start,
                       spec=spec, files=files)
    finally:
        sweep.Run = plain


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    run.cache_env()
    sys.path.insert(0, str(run.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("program_split: needs a CUDA card", file=sys.stderr)
        return 2
    out = split(a.workload, a.seed, a.seconds)
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
