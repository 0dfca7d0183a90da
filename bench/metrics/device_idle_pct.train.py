"""The share of the traced train window in which no operation ran on the
card, from the profiler's timeline."""


def read(obs):
    if not obs["window_s"] or not obs["busy_s"]:
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["window_s"])
