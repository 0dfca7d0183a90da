"""The card's idle share of the traced train window while the port's
``tick.step`` span (the train step's call) is open; with
``between_steps_idle_pct.train`` it adds up to ``device_idle_pct.train``."""
from benchlib.program_trace import span


def read(obs):
    idle = span(obs, "tick.step").get("idle_s")
    if idle is None or not obs["window_s"] or not obs["busy_s"]:
        return None
    return 100.0 * idle / obs["window_s"]
