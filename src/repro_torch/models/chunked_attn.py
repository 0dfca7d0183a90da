"""Memory-sane chunked attention in plain PyTorch: a loop over query
chunks (the reference's ``models/chunked_attn.py``).

Used where ``cfg.attn_impl == "chunked"`` on tensors that are not on the
card (:func:`repro_torch.models.attention._sdpa`): the dry run's count on
meta tensors, and the CPU. On the card the flash kernel is the only path.
Peak memory is bounded by one (q_chunk x S_kv) logits block per head: each
chunk's body runs under ``torch.utils.checkpoint``, so its logits are
recomputed in the backward instead of saved (the reference's
``jax.checkpoint`` per scan body).

Baseline schedule is *rectangular*: every q-chunk attends to the full KV
with causal masking (2x FLOP waste on causal attention). The
*triangle-packed* schedule (``packed=True``) pairs q-chunk i with q-chunk
N-1-i so each pair covers a constant number of KV chunks: exact causal
FLOPs with static shapes. Both are kept selectable, as in the reference.
"""
from __future__ import annotations

from typing import List

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _attend_block(qg, k, v, *, scale, mask):
    """qg: [B,Q,Hkv,G,Dh]; k/v: [B,K,Hkv,Dh]; mask: [Q,K] bool.
    Returns (out_unnorm [B,Hkv,G,Q,Dh] f32, lse-parts (m, l))."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    logits = torch.where(mask, logits, NEG_INF)
    m = torch.amax(logits, dim=-1)                            # [B,H,G,Q]
    p = torch.exp(logits - m[..., None])
    l = torch.sum(p, dim=-1)                                  # [B,H,G,Q]
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return out, m, l


def _chunked(q: torch.Tensor, n: int, q_chunk: int, hkv: int, g: int
             ) -> torch.Tensor:
    """[B,Sq,Hq,Dh] -> [B,n,q_chunk,Hkv,G,Dh]; the query length must split
    into whole chunks (the reference's reshape fails otherwise)."""
    b, sq, _, dh = q.shape
    if sq % q_chunk:
        raise ValueError(f"query length {sq} is not a multiple of q_chunk "
                         f"{q_chunk}")
    return q.reshape(b, n, q_chunk, hkv, g, dh)


def _stitch(outs: List[torch.Tensor], b, sq, hq, dh, dtype) -> torch.Tensor:
    """Chunk outputs [B,Hkv,G,Q,Dh] in order -> [B,Sq,Hq,Dh]."""
    out = torch.cat([o.movedim(3, 1) for o in outs], dim=1)  # [B,Sq,H,G,D]
    return out.reshape(b, sq, hq, dh).to(dtype)


def chunked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int = 0, q_chunk: int = 1024,
                 packed: bool = False, scale=None) -> torch.Tensor:
    """q: [B,Sq,Hq,Dh]; k/v: [B,Skv,Hkv,Dh]; Sq == Skv (train/prefill);
    ``scale`` the softmax scale (None: ``Dh ** -0.5``)."""
    if packed and causal and not window:
        return _packed_causal(q, k, v, q_chunk=q_chunk, scale=scale)
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    q_chunk = min(q_chunk, sq)
    nq = sq // q_chunk
    qg = _chunked(q, nq, q_chunk, hkv, g)
    kpos = torch.arange(skv, device=q.device)

    def body(qi, i, k, v):
        qpos = i * q_chunk + torch.arange(q_chunk, device=q.device)
        mask = torch.ones((q_chunk, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        out, m, l = _attend_block(qi, k, v, scale=scale, mask=mask)
        return out / torch.clamp(l, min=1e-30)[..., None]

    # flash-attention backward semantics: recompute the chunk's logits in
    # the backward pass instead of saving [B,H,Q,Skv] softmax residuals
    outs = [checkpoint(body, qg[:, i], i, k, v, use_reentrant=False)
            for i in range(nq)]
    return _stitch(outs, b, sq, hq, dh, q.dtype)


def _packed_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_chunk: int, scale=None) -> torch.Tensor:
    """Triangle-packed causal schedule.

    Pair q-chunk i (needs kv[0:(i+1)c]) with q-chunk n-1-i (needs
    kv[0:(n-i)c]). The low half of the KV serves both chunks of a pair, the
    high half only the long row j = n-1-i; both chunks use per-element
    causal masks, so packing changes only the iteration space. An odd
    chunk count takes the rectangular schedule.
    """
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    q_chunk = min(q_chunk, sq)
    n = sq // q_chunk
    if n % 2 != 0:
        return chunked_sdpa(q, k, v, causal=True, q_chunk=q_chunk,
                            scale=scale)
    scale = dh ** -0.5 if scale is None else scale
    qg = _chunked(q, n, q_chunk, hkv, g)
    half = skv // 2
    kpos_lo = torch.arange(half, device=q.device)
    kpos_hi = half + torch.arange(half, device=q.device)
    k_lo, v_lo = k[:, :half], v[:, :half]
    k_hi, v_hi = k[:, half:], v[:, half:]
    ar = torch.arange(q_chunk, device=q.device)

    def pair_body(qi, qj, i, k_lo, v_lo, k_hi, v_hi):
        j = n - 1 - i
        qpos_i, qpos_j = i * q_chunk + ar, j * q_chunk + ar
        # low half serves both rows; high half serves only the long row j
        qc = torch.cat([qi, qj], dim=1)                    # [B,2Q,H,G,D]
        qpos = torch.cat([qpos_i, qpos_j])
        mask_lo = kpos_lo[None, :] <= qpos[:, None]
        out_lo, m_lo, l_lo = _attend_block(qc, k_lo, v_lo, scale=scale,
                                           mask=mask_lo)
        mask_hi = kpos_hi[None, :] <= qpos_j[:, None]
        out_hi, m_hi, l_hi = _attend_block(qj, k_hi, v_hi, scale=scale,
                                           mask=mask_hi)
        # combine row j (softmax merge of two partials)
        m_lo_j = m_lo[..., q_chunk:]
        l_lo_j = l_lo[..., q_chunk:]
        out_lo_j = out_lo[..., q_chunk:, :]
        m_j = torch.maximum(m_lo_j, m_hi)
        a1 = torch.exp(m_lo_j - m_j)[..., None]
        a2 = torch.exp(m_hi - m_j)[..., None]
        out_j = out_lo_j * a1 + out_hi * a2
        l_j = l_lo_j * a1[..., 0] + l_hi * a2[..., 0]
        out_i = out_lo[..., :q_chunk, :] / torch.clamp(
            l_lo[..., :q_chunk], min=1e-30)[..., None]
        out_j = out_j / torch.clamp(l_j, min=1e-30)[..., None]
        return out_i, out_j

    outs: List[torch.Tensor] = [None] * n
    for i in range(n // 2):
        outs[i], outs[n - 1 - i] = checkpoint(
            pair_body, qg[:, i], qg[:, n - 1 - i], i, k_lo, v_lo, k_hi, v_hi,
            use_reentrant=False)
    return _stitch(outs, b, sq, hq, dh, q.dtype)
