"""Device ms a task of the kernels launched inside the port's
``moe.route``, ``moe.dispatch`` and ``moe.combine`` spans: the MoE
layers' router, sort, permutations and weighted combine, everything of
the layer but its grouped products (forward and remat's recompute)."""
from benchlib.program_trace import device_ms_a_task

SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(obs):
    got = [device_ms_a_task(obs, s) for s in SPANS]
    return None if any(v is None for v in got) else sum(got)
