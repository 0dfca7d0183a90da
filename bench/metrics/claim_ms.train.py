"""Mean ms of the executor's ``claim_all`` in a tick (the queue's claim
through ``wq_claim``): the CPU time of the driving thread inside the
benchmark's span around it, so not the time it waited for the interpreter
lock while the analyst thread's sweep held it (the result's ``info`` gives
the wall time and that wait)."""


def read(obs):
    t = obs["span_cpu"].get("claim", [])
    return 1e3 * sum(t) / len(t) if t else None
