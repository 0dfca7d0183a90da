"""Launcher of the CUDA SSD chunked scan (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py`` (``_ssd_kernel``
/ ``ssd_scan_fwd``) together with the per-chunk cumsum of its dispatcher
(``repro/kernels/ssd_scan/ops.py``), which the kernel computes itself; the
source note in the ``.cu`` file says what bounds it on the card and how its
design answers that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library

MAX_STATE = 256     # widest N the kernel is instantiated for


def ssd_scan_fwd(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                 dt: torch.Tensor, da: torch.Tensor, *, chunk: int = 256,
                 heads_per_bc: int = 1):
    """x: [BH,S,P]; bmat/cmat: [BH/heads_per_bc,S,N]; dt/da: [BH,S] (or
    [BH,S,1]); contiguous CUDA tensors of one dtype (fp32 or bf16), computed
    in fp32. Returns (y [BH,S,P] in x's dtype, final state [BH,P,N] fp32).
    A ragged last chunk is masked, which equals zero-dt padding."""
    library.refuse_grad("ssd_scan", x, bmat, cmat, dt, da,
                        item=library.TRAINING_ITEM)
    library.require_cuda("ssd_scan", x, bmat, cmat, dt, da)
    dtypes = {x.dtype, bmat.dtype, cmat.dtype, dt.dtype, da.dtype}
    if len(dtypes) != 1 or x.dtype not in library.DTYPE_CODES:
        raise TypeError(f"ssd_scan: inputs must share dtype float32 or "
                        f"bfloat16, got {sorted(map(str, dtypes))}")
    if x.dim() != 3 or bmat.dim() != 3 or bmat.shape != cmat.shape:
        raise ValueError("ssd_scan: expected x [BH,S,P], B/C [BH/g,S,N]")
    bh, s, p = x.shape
    n = bmat.shape[-1]
    g = int(heads_per_bc)
    if g < 1 or bh % g or bmat.shape[:2] != (bh // g, s) or n > MAX_STATE \
            or dt.numel() != bh * s or da.numel() != bh * s or chunk < 1:
        raise ValueError(
            f"ssd_scan: bad shapes x {tuple(x.shape)} B {tuple(bmat.shape)} "
            f"dt {tuple(dt.shape)} da {tuple(da.shape)} (heads_per_bc {g}, "
            f"chunk {chunk}, N <= {MAX_STATE})")
    lib = library.library()
    y = torch.empty_like(x)
    state = torch.empty((bh, p, n), dtype=torch.float32, device=x.device)
    work = torch.empty(lib.ssd_scan_scratch_floats(bh, s, p, n, int(chunk), g),
                       dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        library.launch("ssd_scan_launch", x.data_ptr(), bmat.data_ptr(),
                       cmat.data_ptr(), dt.data_ptr(), da.data_ptr(),
                       y.data_ptr(), state.data_ptr(), work.data_ptr(), bh, s,
                       p, n, int(chunk), g, library.DTYPE_CODES[x.dtype],
                       library.stream_of(x))
    ssd_scan_fwd.launches += 1
    return y, state


ssd_scan_fwd.launches = 0
