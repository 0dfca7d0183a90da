"""Mean wall ms of the port's ``tick.claim`` span (the rebalance and the
queue's ``claim_all`` through ``wq_claim``) in the traced train window,
by the tracer's own clock: the time it waited for the interpreter lock
included, which ``claim_ms.train`` leaves out."""
from benchlib.program_trace import span


def read(obs):
    t = span(obs, "tick.claim").get("wall_s")
    return 1e3 * sum(t) / len(t) if t else None
