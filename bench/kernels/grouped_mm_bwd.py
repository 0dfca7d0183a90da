"""The grouped product's backward (``GroupedMmBackward0``): dx = dy w[g]^T
and dw[g] = x_g^T dy_g, 4 M K N operations; dy, x and w read once, dx and
dw written once."""
from __future__ import annotations

from benchlib import cells

OP, LABEL, NODE = "grouped_mm", "grouped_mm", "GroupedMm"
# the node carries no shapes: its calls are counted at the forward calls'
shape = cells.kernel_file("grouped_mm_fwd").shape


def count(m, k, n, g, dtype):
    """(operations, bytes, operand dtype) of one call."""
    elt = 2 if dtype in ("bfloat16", "float16") else 4
    return 4.0 * m * k * n, \
        elt * (m * n + 2 * m * k + 2 * g * k * n) + 4.0 * g, \
        "bfloat16" if elt == 2 else "float32"
