"""The SSD scan backward, chunked: per chunk and B/C row the scores C B^T
and the products W B and W^T C on the lower triangle; per chunk and head
the lower-triangle products M^T dy and dy x^T and five [Q,P] x [P,N]
products (the state entering the chunk, the chunk's dH term, dH B, and
the state terms of dC and dB). x, B, C, dt, da and dy read and the five
gradients written once, fp32, counted at the TF32 peak
(``benchlib.peaks``)."""
from __future__ import annotations

from benchlib import cells

OP, LABEL, NODE = "ssd_scan", "ssd", "SSDScanFn"
# the node carries no shapes: its calls are counted at the forward calls'
shape = cells.kernel_file("ssd_fwd").shape


def count(x, bc, dtype="float32", chunk=256, heads_per_bc=1):
    """(operations, bytes, operand dtype) of one call; x [BH,S,P], B/C
    [BH/heads_per_bc,S,N]."""
    bh, s, p = x
    rows, n = bc[0], bc[2]
    pairs = steps = 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs += q * (q + 1) // 2
        steps += q
    ops = 2.0 * (3 * rows * pairs * n
                 + bh * (2 * pairs * p + 5 * steps * p * n))
    nbytes = 4 * (3 * bh * s * p + 4 * rows * s * n + 4 * bh * s)
    return ops, nbytes, "float32"
