"""Launchers of the CUDA cross-entropy of the chunked LM-head loss and its
backward (``csrc/cross_entropy.cu``).

Neither replaces a TPU kernel: the reference's ``chunked_xent``
(``repro/models/transformer.py``) computes each chunk's loss with XLA's
logsumexp and gather, and XLA differentiates them. The source note in the
``.cu`` file says what bounds each on the card and how its design answers
that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library


def _check(name, logits, labels):
    library.require_cuda(name, logits, labels)
    if logits.dtype not in library.DTYPE_CODES:
        raise TypeError(f"{name}: logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if labels.dtype not in library.LABEL64:
        raise TypeError(f"{name}: labels must be int32 or int64, got "
                        f"{labels.dtype}")
    if logits.dim() != 2 or logits.shape[1] == 0 \
            or labels.shape != logits.shape[:1]:
        raise ValueError(f"{name}: expected logits [R,V] (V > 0) and labels "
                         f"[R], got {tuple(logits.shape)}, "
                         f"{tuple(labels.shape)}")


def cross_entropy_fwd(logits: torch.Tensor, labels: torch.Tensor):
    """(lse, gold), each [R] fp32, of logits [R,V] (fp32 or bf16, computed
    in fp32) at labels [R] (int32 or int64), contiguous CUDA tensors: the
    row's logsumexp and its logit at the label (NaN for a label outside
    [0, V)). Any R and V.

    Forward only: with grad enabled and logits that require grad it
    raises; :class:`~repro_torch.kernels.cross_entropy.ops.CrossEntropyFn`
    (through ``kernels.ops.cross_entropy``) is the differentiable call."""
    library.refuse_grad("cross_entropy", logits,
                        item="train through kernels.ops.cross_entropy, "
                             "whose CrossEntropyFn launches the backward")
    _check("cross_entropy", logits, labels)
    r, v = logits.shape
    lse = torch.empty(r, dtype=torch.float32, device=logits.device)
    gold = torch.empty_like(lse)
    with torch.cuda.device(logits.device):
        library.launch("cross_entropy_launch", logits.data_ptr(),
                       labels.data_ptr(), lse.data_ptr(), gold.data_ptr(), r,
                       v, library.DTYPE_CODES[logits.dtype],
                       library.LABEL64[labels.dtype],
                       library.stream_of(logits))
    cross_entropy_fwd.launches += 1
    return lse, gold


cross_entropy_fwd.launches = 0


def cross_entropy_bwd(logits: torch.Tensor, labels: torch.Tensor,
                      lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient [R,V], in the logits' dtype, of the rows' loss ``lse -
    gold`` for its gradient ``g`` (fp32, [R] or one value for every row:
    a tensor whose strides are all 0, as a sum's backward expands it, is
    read as that one value from device memory), computed in fp32: g[r]
    (exp(l[r,j] - lse[r]) - [j == label[r]]) (the function of
    :func:`~repro_torch.kernels.cross_entropy.ref.cross_entropy_bwd_ref`).
    Its output has no gradient path, so with grad enabled (a double
    backward) it raises on inputs that require grad."""
    library.refuse_grad("cross_entropy_bwd", logits, g,
                        item="a double backward through the cross-entropy "
                             "is not ported")
    _check("cross_entropy_bwd", logits, labels)
    r, v = logits.shape
    g = g.float()
    stride = 0 if all(s == 0 for s in g.stride()) else 1
    if stride:
        g = g.contiguous()
    if lse.dtype != torch.float32 or lse.shape != (r,) \
            or g.numel() not in (1, r):
        raise ValueError(f"cross_entropy_bwd: expected lse [R] fp32 and g "
                         f"[R] or one value, got {tuple(lse.shape)} "
                         f"{lse.dtype}, {tuple(g.shape)}")
    library.require_cuda("cross_entropy_bwd", logits, lse)
    if g.device != logits.device:
        raise ValueError(f"cross_entropy_bwd: g on {g.device}, logits on "
                         f"{logits.device}")
    out = torch.empty_like(logits)
    with torch.cuda.device(logits.device):
        library.launch("cross_entropy_bwd_launch", logits.data_ptr(),
                       labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
                       stride, out.data_ptr(), r, v,
                       library.DTYPE_CODES[logits.dtype],
                       library.LABEL64[labels.dtype],
                       library.stream_of(logits))
    cross_entropy_bwd.launches += 1
    return out


cross_entropy_bwd.launches = 0
