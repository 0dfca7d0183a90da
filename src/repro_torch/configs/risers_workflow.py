"""The paper's own workflow: Risers Fatigue Analysis (Fig. 8).

Seven chained activities; each activity-k task spawns an activity-(k+1) task on
completion (1:1 pipeline, as in the paper's synthetic workloads derived from the
Risers specification). Domain columns mirror the paper's examples: input params
(a, b, c ~ environmental conditions), outputs (x, y ~ stress results), and the
Q7 f1 wear-and-tear output.

Used by benchmarks/exp*.py and examples/parameter_sweep_steering.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class WorkflowConfig:
    name: str = "risers-fatigue-analysis"
    activities: Tuple[str, ...] = (
        "preprocessing",         # paper: Pre-Processing (produces cx, cy, cz)
        "analyze_risers",        # Q8 retargets inputs of this activity
        "calculate_wear_tear",   # produces f1 (Q7 filters f1 > 0.5)
        "dynamic_analysis",
        "static_analysis",
        "fatigue_assessment",
        "postprocessing",
    )
    # synthetic-workload knobs (paper Section 5.1): #tasks and mean duration
    num_tasks: int = 13_000
    mean_task_duration_s: float = 60.0
    # domain parameter ranges (wind speed / wave frequency analogues)
    param_low: float = 0.0
    param_high: float = 40.0

    @property
    def num_activities(self) -> int:
        return len(self.activities)


DEFAULT = WorkflowConfig()

# Paper experiment workloads (Section 5)
EXP1_WORKLOAD = WorkflowConfig(num_tasks=13_000, mean_task_duration_s=60.0)
EXP2_WORKLOADS = tuple(
    WorkflowConfig(num_tasks=n, mean_task_duration_s=60.0)
    for n in (6_000, 12_000, 23_400)
)
EXP3_TASK_COUNTS = (4_600, 12_000, 23_400)
EXP3_DURATIONS = (5.0, 60.0)
EXP4_DURATIONS = (5.0, 10.0, 30.0, 60.0, 120.0)
EXP4_TASK_COUNTS = (4_600, 23_400)
EXP5_DURATIONS = (1.0, 2.0, 3.0, 4.0, 5.0, 10.0, 30.0, 60.0)
EXP5_TASKS = 23_400
EXP8_WORKLOADS = (
    ("medium-short", 5_000, 1.0),
    ("medium-long", 5_000, 16.0),
    ("large-short", 20_000, 1.0),
    ("large-long", 20_000, 16.0),
)
