"""Plain PyTorch versions of flash attention: the forward (fp32 softmax),
the row log-sum-exp its kernel writes for the backward, and the backward
with dq / dk / dv written out."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(sq, skv, causal, window, device):
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _scale(dh, scale):
    return dh ** -0.5 if scale is None else scale


def _scores(q, k, causal, window, scale=None):
    """Scaled logits [B,Hkv,g,Sq,Skv] in fp32 with masked keys at NEG_INF,
    and the mask [Sq,Skv]; ``scale`` None is ``dh ** -0.5``."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        * _scale(dh, scale)
    mask = _mask(sq, skv, causal, window, q.device)
    return torch.where(mask, s, NEG_INF), mask


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q: [B,S,Hq,DH]; k/v: [B,Skv,Hkv,DH]; query head h reads KV head
    h // (Hq/Hkv); the logits scaled by ``scale`` (None: ``dh ** -0.5``).
    Computed in fp32, returned in q's dtype."""
    b, sq, hq, dh = q.shape
    s, _ = _scores(q, k, causal, window, scale)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal=True, window=0, scale=None):
    """[B,Hq,S] fp32: the natural-log log-sum-exp of each row's scaled
    logits ``scale q.k`` (None: ``dh**-0.5``) over its visible keys (the
    forward kernel's ``lse``; +inf for a row that sees no key)."""
    b, sq, hq, _ = q.shape
    s, mask = _scores(q, k, causal, window, scale)
    lse = torch.logsumexp(s, dim=-1).reshape(b, hq, sq)
    seen = mask.any(-1)
    return torch.where(seen, lse, torch.inf)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0,
                            scale=None):
    """(dq, dk, dv) in q's dtype, computed explicitly in fp32 as the
    backward kernel computes them: P = exp(s - lse) on the visible pairs, D
    = rowsum(do * o), dS = P (do v^T - D), dv = P^T do, dk = scale dS^T q,
    dq = scale dS k; dk and dv of a KV head summed over its query heads."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = _scale(dh, scale)
    s, mask = _scores(q, k, causal, window, scale)
    lse_g = lse.float().reshape(b, hkv, g, sq)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dog = do.float().reshape(b, sq, hkv, g, dh)
    qg = q.float().reshape(b, sq, hkv, g, dh)
    delta = (dog * o.float().reshape(b, sq, hkv, g, dh)).sum(-1)  # [b,q,h,g]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    return (dq.reshape(b, sq, hq, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
