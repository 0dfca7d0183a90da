"""Launchers of the CUDA RG-LRU scan and its backward
(``csrc/rglru_scan.cu``).

The forward replaces the TPU kernel ``repro/kernels/rglru_scan/kernel.py``
(``_rglru_kernel`` / ``rglru_scan_fwd``). The backward has no Pallas
counterpart: the reference differentiates its associative scan with XLA's
autodiff. The source note in the ``.cu`` file says what bounds each on the
card and how its design answers that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library


def _check(name, x, y):
    if x.dtype != y.dtype or x.dtype not in library.DTYPE_CODES:
        raise TypeError(f"{name}: inputs must share dtype float32 or "
                        f"bfloat16, got {x.dtype}, {y.dtype}")
    if x.dim() != 3 or x.shape != y.shape:
        raise ValueError(f"{name}: expected [B,S,C] inputs of one shape, "
                         f"got {tuple(x.shape)}, {tuple(y.shape)}")


def rglru_scan_fwd(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """a, u: [B,S,C], contiguous CUDA tensors of one dtype (fp32 or bf16),
    computed in fp32. Returns h [B,S,C] in a's dtype, h_t = a_t h_{t-1} +
    u_t with h_0 = 0. Any B, S and C (no padding).

    Forward only: with grad enabled and an input that requires grad it
    raises; :class:`~repro_torch.kernels.rglru_scan.ops.RGLRUScanFn`
    (through ``kernels.ops.rglru_scan``) is the differentiable call."""
    library.refuse_grad("rglru_scan", a, u, item=library.TRAINING_ITEM)
    library.require_cuda("rglru_scan", a, u)
    _check("rglru_scan", a, u)
    b, s, c = a.shape
    h = torch.empty_like(a)
    with torch.cuda.device(a.device):
        library.launch("rglru_scan_launch", a.data_ptr(), u.data_ptr(),
                       h.data_ptr(), b, s, c, library.DTYPE_CODES[a.dtype],
                       library.stream_of(a))
    rglru_scan_fwd.launches += 1
    return h


rglru_scan_fwd.launches = 0


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """(da, du) [B,S,C] in a's dtype of the scan whose output was ``h``, for
    the output gradient ``g``; a, h, g contiguous CUDA tensors of one dtype
    and shape, computed in fp32 (the function of
    :func:`~repro_torch.kernels.rglru_scan.ref.rglru_scan_bwd_ref`). Its
    outputs have no gradient path, so with grad enabled (a double
    backward) it raises on inputs that require grad."""
    library.refuse_grad("rglru_scan_bwd", a, h, g,
                        item="a double backward through the RG-LRU scan is "
                        "not ported")
    library.require_cuda("rglru_scan_bwd", a, h, g)
    _check("rglru_scan_bwd", a, h)
    _check("rglru_scan_bwd", a, g)
    b, s, c = a.shape
    da, du = torch.empty_like(a), torch.empty_like(a)
    with torch.cuda.device(a.device):
        library.launch("rglru_scan_bwd_launch", a.data_ptr(), h.data_ptr(),
                       g.data_ptr(), da.data_ptr(), du.data_ptr(), b, s, c,
                       library.DTYPE_CODES[a.dtype], library.stream_of(a))
    rglru_scan_bwd.launches += 1
    return da, du


rglru_scan_bwd.launches = 0
