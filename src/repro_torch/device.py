"""Where the port runs: entry points default to the CUDA card and refuse to
start without one; the caller asks for the CPU explicitly."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and none is present (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the host")
    return dev
