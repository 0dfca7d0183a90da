"""The SSD scan forward, chunked: per chunk the lower triangle of C B^T
(once per B/C row), its product with dt x (per head), C S^T from the
second chunk on and the state update; x, B, C, dt and da read and y and
the final state written once. fp32 operands are counted at the TF32 peak
(``benchlib.peaks``)."""
from __future__ import annotations

OP = "ssd_scan"                 # its entry in repro_torch.kernels.ops
LABEL = "ssd"
NODE = "SSDScanFn"              # its backward node: ssd_bwd.py


def shape(x, bmat, cmat, dt, da, **kw):
    """``count``'s keywords of a call of the entry."""
    return {"x": tuple(x.shape), "bc": tuple(bmat.shape),
            "dtype": str(x.dtype).replace("torch.", ""),
            "chunk": kw.get("chunk", 256),
            "heads_per_bc": kw.get("heads_per_bc", 1)}


def count(x, bc, dtype, chunk=256, heads_per_bc=1):
    """(operations, bytes, operand dtype) of one call; x [BH,S,P], B/C
    [BH/heads_per_bc,S,N]."""
    bh, s, p = x
    rows, n = bc[0], bc[2]
    pairs = carry = upd = 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs += q * (q + 1) // 2
        carry += q if c0 else 0
        upd += q
    ops = 2.0 * (rows * pairs * n + bh * pairs * p
                 + bh * (carry + upd) * n * p)
    elt = 2 if dtype in ("bfloat16", "float16") else 4
    nbytes = elt * (2 * bh * s * p + 2 * rows * s * n + 2 * bh * s) \
        + 4 * bh * p * n
    return ops, nbytes, "bfloat16" if elt == 2 else "float32"
