"""Device ms a task of the kernels launched inside the port's dropless MoE
spans (``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``):
every MoE layer's forward and remat's recompute of it. The backward's own
products are read by ``grouped_mm_bwd_roofline_pct.train``."""
from benchlib.program_trace import device_ms_a_task

SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def read(obs):
    got = [device_ms_a_task(obs, s) for s in SPANS]
    return None if any(v is None for v in got) else sum(got)
