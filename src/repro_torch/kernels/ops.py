"""Dispatch for the port's kernels, by the tensors' device.

Mirrors ``repro/kernels/ops.py`` of the reference package without its
switches: a CUDA tensor always goes to the hand-written Hopper kernel (or
the call raises), a CPU tensor to the kernel's plain PyTorch version. There
is no environment switch and no fallback from the card to the plain
version.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: F401
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: F401
from repro_torch.kernels.wq_claim.ops import wq_claim, wq_claim_columns  # noqa: F401
