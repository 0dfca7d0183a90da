"""Dispatcher for the SSD scan: by the tensors' device.

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the plain PyTorch version. The reference's dispatcher
computes the per-chunk inclusive cumsum of ``da`` (reset at every chunk
boundary) before its kernel; here the kernel does that itself, so both
routes take ``da`` as it is. Any S: a ragged last chunk is masked, which
equals the reference model's zero-dt padding.
"""
from __future__ import annotations

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def ssd_scan(x, bmat, cmat, dt, da, *, chunk: int = 256,
             heads_per_bc: int = 1):
    """x: [BH,S,P]; bmat/cmat: [BH/heads_per_bc,S,N]; dt/da: [BH,S,1] or
    [BH,S]. ``heads_per_bc`` is 1 for the reference's layout (B/C per
    (batch, head) row) and H when the model passes B/C once per batch row.
    Returns (y [BH,S,P] in x's dtype, final state [BH,P,N] in fp32)."""
    if x.device.type == "cuda":
        return ssd_scan_fwd(x.contiguous(), bmat.contiguous(),
                            cmat.contiguous(), dt.contiguous(),
                            da.contiguous(), chunk=chunk,
                            heads_per_bc=heads_per_bc)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    return ssd_scan_ref(x, bmat, cmat, dt, da, heads_per_bc=heads_per_bc)
