"""Plain PyTorch version of the flash-attention forward (fp32 softmax)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: [B,S,Hq,DH]; k/v: [B,Skv,Hkv,DH]; query head h reads KV head
    h // (Hq/Hkv). Computed in fp32, returned in q's dtype."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5
    qg = q.reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)
