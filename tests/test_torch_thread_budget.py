"""The CPU-thread budget that the root ``conftest.py`` gives each
pytest-xdist worker: torch in the worker, and a process the worker starts,
run at the worker's share of the usable CPUs. Without ``-n`` no budget is
set and the tests pass without asserting one."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")


def _share():
    """The worker's share of the usable CPUs, or None outside a worker."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, len(os.sched_getaffinity(0)) // int(workers))


def test_worker_runs_torch_at_its_share():
    share = _share()
    if share is None:
        return
    assert os.environ["OMP_NUM_THREADS"] == str(share)
    assert torch.get_num_threads() == share


def test_child_inherits_the_share():
    share = _share()
    if share is None:
        return
    out = subprocess.run(
        [sys.executable, "-c",
         "import os, torch; "
         "print(os.environ['OMP_NUM_THREADS'], torch.get_num_threads())"],
        env=os.environ, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(share), str(share)]
