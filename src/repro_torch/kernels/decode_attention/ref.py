"""Plain PyTorch version of decode attention (1 token vs a cache of kv_len)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, kv_len):
    """q: [B,1,Hq,DH]; k/v: [B,Smax,Hkv,DH]; kv_len: one int32 value as a
    tensor on q's device. Positions >= kv_len are masked. fp32 inside, q's
    dtype out."""
    b, _, hq, dh = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5
    qg = q.reshape(b, 1, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = torch.arange(smax, device=q.device) < kv_len.reshape(())
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, 1, hq, dh).to(q.dtype)
