"""Flash attention backward: 10 Dh Hq operations per visible (query, key)
pair and batch row (S = Q K^T, dP = dO V^T, dV, dK, dQ); q, k, v, o, dO
and the LSE read and dq, dk, dv written once. fp32 operands are counted
at the TF32 peak (``benchlib.peaks``)."""
from __future__ import annotations

from benchlib import cells
from benchlib.roofline import attention_pairs

OP, LABEL, NODE = "flash_attention", "flash", "FlashAttentionFn"
# the node carries no shapes: its calls are counted at the forward calls'
shape = cells.kernel_file("flash_fwd").shape


def count(q, kv, dtype, causal=True, window=0):
    """(operations, bytes, operand dtype) of one call; q [B,S,Hq,Dh], kv
    [B,Skv,Hkv,Dh]."""
    b, s, hq, dh = q
    skv, hkv = kv[1], kv[2]
    elt = 2 if dtype in ("bfloat16", "float16") else 4
    ops = 10.0 * b * hq * dh * attention_pairs(s, skv, causal, window)
    nbytes = elt * b * dh * 4 * (s * hq + skv * hkv) + 4 * b * hq * s
    return ops, nbytes, "bfloat16" if elt == 2 else "float32"
