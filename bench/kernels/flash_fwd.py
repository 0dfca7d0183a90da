"""Flash attention forward with the row log-sum-exp (the train path's
call): 4 Dh Hq operations per visible (query, key) pair and batch row
(Q K^T and P V); q, k and v read and o and the LSE written once. fp32
operands are counted at the TF32 peak (``benchlib.peaks``)."""
from __future__ import annotations

from benchlib.roofline import attention_pairs

OP = "flash_attention"          # its entry in repro_torch.kernels.ops
LABEL = "flash"
NODE = "FlashAttentionFn"       # its backward node: flash_bwd.py


def shape(q, k, v, **kw):
    """``count``'s keywords of a call of the entry."""
    return {"q": tuple(q.shape), "kv": tuple(k.shape),
            "dtype": str(q.dtype).replace("torch.", ""),
            "causal": kw.get("causal", True), "window": kw.get("window", 0)}


def count(q, kv, dtype, causal=True, window=0, lse=True):
    """(operations, bytes, operand dtype) of one call; q [B,S,Hq,Dh], kv
    [B,Skv,Hkv,Dh]."""
    b, s, hq, dh = q
    skv, hkv = kv[1], kv[2]
    elt = 2 if dtype in ("bfloat16", "float16") else 4
    ops = 4.0 * b * hq * dh * attention_pairs(s, skv, causal, window)
    nbytes = elt * b * dh * (2 * s * hq + 2 * skv * hkv) \
        + (4 * b * hq * s if lse else 0)
    return ops, nbytes, "bfloat16" if elt == 2 else "float32"
