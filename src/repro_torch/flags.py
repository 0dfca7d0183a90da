"""Process-wide flags.

``wq_device_claim()`` — when True, WorkQueues CONSTRUCTED while it holds run
claim_all's primary phase through the ``wq_claim`` op on the queue's device
(the hand-written CUDA kernel for a CUDA device, its plain PyTorch version
for the CPU) instead of the host numpy fast-path (the queue samples the flag
once in __init__; flip ``wq.device_claim`` to switch an existing queue).
Defaults from the REPRO_WQ_DEVICE_CLAIM env var (off unless set to
1/true/yes); ``device_claims()`` scopes the construction-time default.

``TRACE`` — the default of :mod:`repro_torch.trace`'s process-wide switch,
from the REPRO_TRACE env var (off unless set to 1/true/yes).
"""
from __future__ import annotations

import contextlib
import contextvars
import os


def _env_on(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes")


_WQ_DEVICE_CLAIM = contextvars.ContextVar(
    "repro_torch_wq_device_claim", default=_env_on("REPRO_WQ_DEVICE_CLAIM"))
TRACE = _env_on("REPRO_TRACE")


def wq_device_claim() -> bool:
    return _WQ_DEVICE_CLAIM.get()


@contextlib.contextmanager
def device_claims(on: bool = True):
    """Construction-time default for WorkQueue(device_claim=None) within the
    scope; queues built earlier keep whatever they sampled."""
    tok = _WQ_DEVICE_CLAIM.set(on)
    try:
        yield
    finally:
        _WQ_DEVICE_CLAIM.reset(tok)
