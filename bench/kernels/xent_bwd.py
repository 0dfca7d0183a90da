"""The loss chunk's cross-entropy backward (``cross_entropy.cu``'s
``xent_bwd``): each logit read once and its gradient written once in the
logits' dtype, the row's log-sum-exp (fp32) and label (int64) read once;
4 operations a logit (an FMA, an exp, a subtract, a multiply). A copy of
``chip_smoke.xent_ops_bytes``. Its time: ``xent_fwd.py`` says why only
the ``xent_*`` kernels count."""
from __future__ import annotations

from benchlib import cells

OP, LABEL, NODE = "cross_entropy", "xent", "CrossEntropyFn"
KERNELS = ("xent_fwd", "xent_bwd")
# the node carries no shapes: its calls are counted at the forward calls'
shape = cells.kernel_file("xent_fwd").shape


def count(rows, v, dtype):
    """(operations, bytes, operand dtype) of one call on [rows, v]
    logits."""
    elt = 2 if dtype in ("bfloat16", "float16") else 4
    n = rows * v
    return 4.0 * n, 2.0 * elt * n + 12.0 * rows, \
        "bfloat16" if elt == 2 else "float32"
