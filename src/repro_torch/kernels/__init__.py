"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. ``launch_counts()`` reads how often each kernel was launched on the
card (a wrapper counts one per launch of its kernel, nowhere else), and
``reset_launch_counts()`` sets the counts to 0, so that a run can show that
its path went through the kernels."""
from __future__ import annotations

from typing import Dict


def _launchers():
    from repro_torch.kernels.cross_entropy.kernel import (cross_entropy_bwd,
                                                          cross_entropy_fwd)
    from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd,
                                                       rglru_scan_fwd)
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd, ssd_scan_fwd
    from repro_torch.kernels.wq_claim.kernel import wq_claim_fwd
    return {"wq_claim": wq_claim_fwd, "flash_attention": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention_fwd,
            "ssd_scan": ssd_scan_fwd, "ssd_scan_bwd": ssd_scan_bwd,
            "rglru_scan": rglru_scan_fwd, "rglru_scan_bwd": rglru_scan_bwd,
            "cross_entropy": cross_entropy_fwd,
            "cross_entropy_bwd": cross_entropy_bwd}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _launchers().items()}


def reset_launch_counts() -> None:
    """Sets every count to 0, the flash forward's sm90 route's
    (``flash_attention_fwd.sm90_launches``) too."""
    for fn in _launchers().values():
        fn.launches = 0
    _launchers()["flash_attention"].sm90_launches = 0
