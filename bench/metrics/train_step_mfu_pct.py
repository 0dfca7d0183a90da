"""The whole train step's share of the card's bf16 peak: the analytic
model FLOPs of the tasks finished in the traced window over the time from
its start to the last of those finishes, at 989 TFLOP/s."""
from benchlib import peaks


def read(obs):
    if not obs["tasks"] or not obs["task_window_s"]:
        return None
    return 100.0 * obs["tasks"] * obs["step_flops"] \
        / obs["task_window_s"] / peaks.MFU_PEAK
