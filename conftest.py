"""Each pytest-xdist worker's share of the CPUs.

torch's intra-op pool sizes itself from ``OMP_NUM_THREADS`` when torch
loads, and defaults to every usable CPU. With several workers, each of
them, and each process a test starts, would then run as many threads as
the machine has cores, and the threads spend most of their time waiting
for each other. pytest loads this file in every worker before it imports
a test module, so the variable is set before torch reads it, and the
processes a test starts inherit it (a pytest plugin may load numpy, and
its BLAS pool, earlier). Outside a worker (a run without ``-n``, or the
controller) nothing is set.
"""
import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    # assigned, not defaulted: a worker inherits the controller's
    # environment, which may already carry a value sized for one process
    os.environ["OMP_NUM_THREADS"] = str(
        max(1, len(os.sched_getaffinity(0)) // int(_workers)))
