"""GQA attention with a KV cache: causal / sliding-window, no-cache and
linear-cache branches (the ring-buffer branch comes with the hybrid slice).

The compute core (:func:`_sdpa`) chooses by the tensors' device. A CUDA
tensor always goes to a hand-written kernel: a 1-token query against the
cache to the decode kernel, a prefill from position 0 with no cache tail
(of any length, one token included) to the flash kernel, and any other
shape raises. A CPU tensor goes to :func:`sdpa_ref`.
``cfg.attn_impl`` does not select the attention path in this port.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

KVCache = Dict[str, torch.Tensor]  # {"k": [L,B,Smax,Hkv,Dh], "v": ..., "idx": int32 scalar}

NEG_INF = -1e30


class Attention(nn.Module):
    """q/k/v/o projections (q/k/v biased when ``cfg.qkv_bias``)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.q = L.dense_init(gen, d, cfg.num_heads * hd, dtype,
                              bias=cfg.qkv_bias)
        self.k = L.dense_init(gen, d, cfg.num_kv_heads * hd, dtype,
                              bias=cfg.qkv_bias)
        self.v = L.dense_init(gen, d, cfg.num_kv_heads * hd, dtype,
                              bias=cfg.qkv_bias)
        self.o = L.dense_init(gen, cfg.num_heads * hd, d, dtype)


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, x.shape[-1] // n))


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool, window: int = 0, q_offset=0,
             kv_len=None) -> torch.Tensor:
    """Reference scaled-dot-product attention with GQA.

    q: [B,Sq,Hq,Dh], k/v: [B,Skv,Hkv,Dh]. ``q_offset`` is the absolute
    position of q[0] (for decode). ``kv_len`` masks positions >= kv_len
    (cache tail). ``window > 0`` restricts attention to the last ``window``
    positions. Both may be ints or scalar tensors.
    """
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scale = dh ** -0.5
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset   # [Sq,1]
    kpos = torch.arange(skv, device=q.device)[None, :]             # [1,Skv]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < kv_len
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def _sdpa(q, k, v, *, causal, window=0, q_offset=0, kv_len=None):
    if q.device.type == "cuda":
        if q.shape[1] == 1 and kv_len is not None and not window:   # decode
            return kops.decode_attention(q, k, v, kv_len=kv_len)
        if kv_len is None and isinstance(q_offset, int) and q_offset == 0:
            return kops.flash_attention(q, k, v, causal=causal, window=window)
        raise NotImplementedError(
            f"no CUDA attention kernel for q {tuple(q.shape)} with "
            f"causal={causal}, window={window}, q_offset={q_offset!r}, "
            f"kv_len={'set' if kv_len is not None else None}")
    return sdpa_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                    kv_len=kv_len)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  layers: int, device) -> KVCache:
    hd = cfg.resolved_head_dim
    shape = (layers, batch, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": torch.zeros((), dtype=torch.int32, device=device)}


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor,
              causal: bool = True,
              window: int = 0,
              cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_idx: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over x: [B,S,D].

    Training/prefill: cache_kv=None -> attends within x (returns fresh K/V so
    prefill can populate the cache).
    Decode: cache_kv=(k,v) [B,Smax,Hkv,Dh] and cache_idx = #valid entries
    (an int32 scalar tensor); x is the new token(s). The new K/V are written
    into the cache tensors IN PLACE (the reference returns updated copies),
    and the same tensors are returned.
    """
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q = _split_heads(p.q(x), hq)
    k = _split_heads(p.k(x), hkv)
    v = _split_heads(p.v(x), hkv)
    if cfg.rope_theta > 0:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    if cache_kv is None:
        out = _sdpa(q, k, v, causal=causal, window=window)
        new_kv = (k, v)
    elif window and cache_kv[0].shape[1] == window:
        raise NotImplementedError(
            "the ring-buffer (sliding-window) cache comes with the hybrid slice")
    else:
        ck, cv = cache_kv
        pos = cache_idx.long() + torch.arange(x.shape[1], device=x.device)
        ck.index_copy_(1, pos, k.to(ck.dtype))
        cv.index_copy_(1, pos, v.to(cv.dtype))
        kv_len = cache_idx + x.shape[1]
        out = _sdpa(q, ck, cv, causal=causal, window=window,
                    q_offset=cache_idx, kv_len=kv_len)
        new_kv = (ck, cv)
    return p.o(_merge_heads(out)), new_kv
