"""Mean ms of one steering sweep (``run_all`` on a store snapshot) on the
analyst thread: the CPU time of that thread inside the benchmark's span
around it, so not the time it waited for the interpreter lock while the
train loop's dispatch held it (the result's ``info`` gives the wall time
and that wait)."""


def read(obs):
    t = obs["span_cpu"].get("steer", [])
    return 1e3 * sum(t) / len(t) if t else None
