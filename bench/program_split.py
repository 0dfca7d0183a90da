"""Run one cell of BENCHMARK.json once, traced: ``bench/run.py --trace 1``,
whose traced window turns the port's own spans on and reads their split.

    python3 bench/program_split.py --workload <cell> --seed <n> \
        --seconds <s>

The result's per-layer metrics hold the split's readings
(``step_idle_pct.train``, ``between_steps_idle_pct.train``, the forward,
backward and optimizer device ms a task, ``claim_wall_ms.train``) and its
``info`` the idle seconds by the port's innermost span open, the device ms
a task by phase and the share of the tasks' device time they cover
(``benchlib/program_trace.py``).
"""
from __future__ import annotations

import sys

import run

if __name__ == "__main__":
    sys.exit(run.main(sys.argv[1:] + ["--trace", "1"]))
