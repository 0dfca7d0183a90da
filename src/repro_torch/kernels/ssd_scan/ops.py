"""Dispatcher for the SSD scan: by the tensors' device.

A CUDA tensor goes to the hand-written kernels (or the call raises); a CPU
tensor goes to the plain PyTorch version, which plain autograd
differentiates (``ref.ssd_scan_bwd_ref`` is the plain backward that the
backward kernel is held against). On the card, a call that needs a gradient (grad enabled and
an input that requires grad) goes through :class:`SSDScanFn`, whose forward
is the forward kernel (keeping its work buffer) and whose backward is the
backward kernel; any other call launches the forward alone. The
reference's dispatcher computes the per-chunk inclusive cumsum of ``da``
(reset at every chunk boundary) before its kernel; here the kernels do that
themselves, so both routes take ``da`` as it is. Any S: a ragged last chunk
is masked, which equals the reference model's zero-dt padding.
A meta tensor (the dry run's count) takes the CPU's route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd, ssd_scan_fwd
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


class SSDScanFn(torch.autograd.Function):
    """The scan with a backward on CUDA tensors, differentiable in x, B, C,
    dt and da (and through the final state it returns): the two kernels.
    It takes fp32 (the backward kernel's type) and saves the inputs, y and
    the forward kernel's work buffer (the states entering each chunk and
    the scores, one layer's worth under remat)."""

    @staticmethod
    def forward(ctx, x, bmat, cmat, dt, da, chunk: int, heads_per_bc: int):
        ctx.set_materialize_grads(False)
        ctx.chunk, ctx.g = int(chunk), int(heads_per_bc)
        if x.dtype != torch.float32:
            raise TypeError(f"ssd_scan: the backward kernel takes fp32 "
                            f"inputs (the mixer scans in fp32), got "
                            f"{x.dtype}")
        y, state, work = ssd_scan_fwd(x, bmat, cmat, dt, da, chunk=chunk,
                                      heads_per_bc=heads_per_bc,
                                      return_work=True)
        ctx.save_for_backward(x, bmat, cmat, dt, da, y, work)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = ctx.saved_tensors
        x = saved[0]
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
        if dstate is not None:
            dstate = dstate.float().contiguous()
        grads = ssd_scan_bwd(*saved, dy, dstate, chunk=ctx.chunk,
                             heads_per_bc=ctx.g)
        return (*grads, None, None)


def ssd_scan(x, bmat, cmat, dt, da, *, chunk: int = 256,
             heads_per_bc: int = 1):
    """x: [BH,S,P]; bmat/cmat: [BH/heads_per_bc,S,N]; dt/da: [BH,S,1] or
    [BH,S]. ``heads_per_bc`` is 1 for the reference's layout (B/C per
    (batch, head) row) and H when the model passes B/C once per batch row.
    Returns (y [BH,S,P] in x's dtype, final state [BH,P,N] in fp32)."""
    if x.device.type == "cuda":
        args = [t.contiguous() for t in (x, bmat, cmat, dt, da)]
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            return SSDScanFn.apply(*args, int(chunk), int(heads_per_bc))
        return ssd_scan_fwd(*args, chunk=chunk, heads_per_bc=heads_per_bc)
    if x.device.type not in ("cpu", "meta"):
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    return ssd_scan_ref(x, bmat, cmat, dt, da, heads_per_bc=heads_per_bc)
