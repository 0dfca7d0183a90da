"""The card's idle share of the traced train window outside the port's
``tick.step`` spans: claims, batches, readbacks, commits and steering
submits between the steps; with ``step_idle_pct.train`` it adds up to
``device_idle_pct.train``."""
from benchlib.program_trace import span


def read(obs):
    w, busy = obs["window_s"], obs["busy_s"]
    idle = span(obs, "tick.step").get("idle_s")
    if idle is None or not w or not busy:
        return None
    return 100.0 * (w - busy - idle) / w
