"""The loss chunk's cross-entropy forward (``cross_entropy.cu``'s
``xent_fwd``): each logit read once, the row's log-sum-exp and gold logit
written once (fp32) and its label read once (int64); 4 operations a logit
(a max, an FMA, an exp, an add). A copy of ``chip_smoke.xent_ops_bytes``.

Its time is that of the ``xent_*`` kernels alone: under the loss chunk's
checkpoint, the backward node ``CrossEntropyFnBackward`` is the first of
the chunk to read a saved tensor, so the chunk's recompute (the logits'
GEMM, this forward) runs inside it."""
from __future__ import annotations

OP = "cross_entropy"            # its entry in repro_torch.kernels.ops
LABEL = "xent"
NODE = "CrossEntropyFn"         # its backward node: xent_bwd.py
KERNELS = ("xent_fwd", "xent_bwd")


def shape(logits, labels):
    """``count``'s keywords of a call of the entry: logits [..., V]."""
    return {"rows": logits.numel() // logits.shape[-1],
            "v": logits.shape[-1],
            "dtype": str(logits.dtype).replace("torch.", "")}


def count(rows, v, dtype):
    """(operations, bytes, operand dtype) of one call on [rows, v]
    logits."""
    elt = 2 if dtype in ("bfloat16", "float16") else 4
    n = rows * v
    return 4.0 * n, elt * n + 16.0 * rows, \
        "bfloat16" if elt == 2 else "float32"
