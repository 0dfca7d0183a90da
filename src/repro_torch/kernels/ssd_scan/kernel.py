"""Launchers of the CUDA SSD chunked scan (``csrc/ssd_scan.cu``) and its
backward (``csrc/ssd_scan_bwd.cu``).

The forward replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py``
(``_ssd_kernel`` / ``ssd_scan_fwd``) together with the per-chunk cumsum of
its dispatcher (``repro/kernels/ssd_scan/ops.py``), which the kernel
computes itself. The backward has no Pallas counterpart: the reference
differentiates its ``ssd_chunked`` with XLA's autodiff. The source notes in
the ``.cu`` files say what bounds each on the card and how its design
answers that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library

MAX_STATE = 256     # widest N the kernel is instantiated for


def _check(name, x, bmat, cmat, dt, da, chunk, heads_per_bc):
    dtypes = {x.dtype, bmat.dtype, cmat.dtype, dt.dtype, da.dtype}
    if len(dtypes) != 1 or x.dtype not in library.DTYPE_CODES:
        raise TypeError(f"{name}: inputs must share dtype float32 or "
                        f"bfloat16, got {sorted(map(str, dtypes))}")
    if x.dim() != 3 or bmat.dim() != 3 or bmat.shape != cmat.shape:
        raise ValueError(f"{name}: expected x [BH,S,P], B/C [BH/g,S,N]")
    bh, s, p = x.shape
    n = bmat.shape[-1]
    g = int(heads_per_bc)
    if g < 1 or bh % g or bmat.shape[:2] != (bh // g, s) or n > MAX_STATE \
            or dt.numel() != bh * s or da.numel() != bh * s or chunk < 1:
        raise ValueError(
            f"{name}: bad shapes x {tuple(x.shape)} B {tuple(bmat.shape)} "
            f"dt {tuple(dt.shape)} da {tuple(da.shape)} (heads_per_bc {g}, "
            f"chunk {chunk}, N <= {MAX_STATE})")
    return bh, s, p, n, g


def ssd_scan_fwd(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                 dt: torch.Tensor, da: torch.Tensor, *, chunk: int = 256,
                 heads_per_bc: int = 1, return_work: bool = False):
    """x: [BH,S,P]; bmat/cmat: [BH/heads_per_bc,S,N]; dt/da: [BH,S] (or
    [BH,S,1]); contiguous CUDA tensors of one dtype (fp32 or bf16), computed
    in fp32. Returns (y [BH,S,P] in x's dtype, final state [BH,P,N] fp32),
    and with ``return_work`` also the kernel's fp32 work buffer (the scores
    C B^T of every chunk, the state entering every chunk and each chunk's
    decay), which :func:`ssd_scan_bwd` reads. A ragged last chunk is
    masked, which equals zero-dt padding.

    Forward only: with grad enabled and an input that requires grad it
    raises; :class:`~repro_torch.kernels.ssd_scan.ops.SSDScanFn` (through
    ``kernels.ops.ssd_scan``) is the differentiable call."""
    library.refuse_grad("ssd_scan", x, bmat, cmat, dt, da,
                        item=library.TRAINING_ITEM)
    library.require_cuda("ssd_scan", x, bmat, cmat, dt, da)
    bh, s, p, n, g = _check("ssd_scan", x, bmat, cmat, dt, da, chunk,
                            heads_per_bc)
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
    return (y, state, work) if return_work else (y, state)


ssd_scan_fwd.launches = 0


def ssd_scan_bwd(x, bmat, cmat, dt, da, y, work, dy, dstate=None, *,
                 chunk: int = 256, heads_per_bc: int = 1):
    """(dx, dB, dC, ddt, dda), each like its input, of the scan whose
    forward (:func:`ssd_scan_fwd` with ``return_work``) gave ``y`` and
    ``work``, for the output gradient ``dy`` (like y) and the final state's
    gradient ``dstate`` (fp32 [BH,P,N]; None for 0), all fp32 (the mixer
    scans in fp32): the function of
    :func:`~repro_torch.kernels.ssd_scan.ref.ssd_scan_bwd_ref`, on the
    caller's stream, with no atomics (repeats are
    bit-identical). Its outputs have no gradient path, so with grad enabled
    (a double backward) it raises on inputs that require grad."""
    library.refuse_grad("ssd_scan_bwd", x, bmat, cmat, dt, da, dy,
                        item="a double backward through the SSD scan is "
                        "not ported")
    tensors = [x, bmat, cmat, dt, da, y, work, dy] + (
        [dstate] if dstate is not None else [])
    library.require_cuda("ssd_scan_bwd", *tensors)
    bh, s, p, n, g = _check("ssd_scan_bwd", x, bmat, cmat, dt, da, chunk,
                            heads_per_bc)
    if x.dtype != torch.float32:
        raise TypeError(f"ssd_scan_bwd: takes fp32 inputs (the mixer scans "
                        f"in fp32), got {x.dtype}")
    lib = library.library()
    if y.shape != x.shape or dy.shape != x.shape or y.dtype != x.dtype or \
            dy.dtype != x.dtype:
        raise ValueError("ssd_scan_bwd: y and dy must be like x")
    if work.dtype != torch.float32 or work.numel() != \
            lib.ssd_scan_scratch_floats(bh, s, p, n, int(chunk), g):
        raise ValueError("ssd_scan_bwd: work is not the forward's buffer")
    if dstate is not None and (dstate.dtype != torch.float32
                               or dstate.shape != (bh, p, n)):
        raise ValueError(f"ssd_scan_bwd: dstate must be fp32 {(bh, p, n)}")
    scratch = torch.empty(
        lib.ssd_scan_bwd_scratch_floats(bh, s, p, n, int(chunk), g),
        dtype=torch.float32, device=x.device)
    dx, db, dc = (torch.empty_like(t) for t in (x, bmat, cmat))
    ddt, dda = torch.empty_like(dt), torch.empty_like(da)
    with torch.cuda.device(x.device):
        library.launch("ssd_scan_bwd_launch", x.data_ptr(), bmat.data_ptr(),
                       cmat.data_ptr(), dt.data_ptr(), da.data_ptr(),
                       y.data_ptr(), dy.data_ptr(),
                       dstate.data_ptr() if dstate is not None else None,
                       work.data_ptr(), scratch.data_ptr(), dx.data_ptr(),
                       db.data_ptr(), dc.data_ptr(), ddt.data_ptr(),
                       dda.data_ptr(), bh, s, p, n, int(chunk), g,
                       library.DTYPE_CODES[x.dtype], library.stream_of(x))
    ssd_scan_bwd.launches += 1
    return dx, db, dc, ddt, dda


ssd_scan_bwd.launches = 0
