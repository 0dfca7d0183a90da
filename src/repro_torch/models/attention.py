"""GQA attention with a KV cache: causal / sliding-window / cross
variants, with the no-cache, linear-cache and ring-buffer branches of the
reference, and M-RoPE (the VLM family's 3-stream positions).

The compute core (:func:`_sdpa`) chooses by the tensors' device. A CUDA
tensor always goes to a hand-written kernel: a 1-token query to the decode
kernel (against the cache, with the window, if any; or, with no cache tail,
against all of its keys: enc-dec's cross-attention at decode, as the
reference's Pallas dispatcher sends it), a prefill or a training pass from
position 0 with no cache tail (causal or not, its keys as many as its
queries or not) to the flash kernel (with grad on, through the autograd
function whose backward is the flash backward kernel; a 1-token query that
needs a gradient goes there too), and any other shape raises. A CPU tensor
goes to :func:`sdpa_ref`, which plain autograd differentiates. The
ring-buffer branch (sliding-window decode against a cache of exactly
``window`` slots) goes to the decode kernel's dispatcher on both devices
(see :func:`attention`). ``cfg.attn_impl`` does not select the card's
path: on tensors that are not on the card, ``"chunked"`` routes a prefill or
a training pass from position 0 with no cache tail to
:func:`repro_torch.models.chunked_attn.chunked_sdpa` (the reference's
conditions), which the dry run counts on meta tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.sharding import is_dtensor, shard, whole_unless_divides

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
    x = whole_unless_divides(x, -1, n)
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


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _sdpa(q, k, v, *, causal, window=0, q_offset=0, kv_len=None,
          attn_impl: str = "ref", q_chunk: int = 256, packed: bool = False):
    if is_dtensor(q):
        # on a mesh: this function on each rank's batch rows and heads
        def local(a, b, c, off, n):
            return _sdpa(a, b, c, causal=causal, window=window,
                         q_offset=off, kv_len=n, attn_impl=attn_impl,
                         q_chunk=q_chunk, packed=packed)
        return kops.attention_on_mesh(local, q, k, v, q_offset, kv_len)
    if q.device.type == "cuda":
        if q.shape[1] == 1 and kv_len is not None:                  # decode
            return kops.decode_attention(q, k, v, kv_len=kv_len,
                                         window=window)
        if q.shape[1] == 1 and not _needs_grad(q, k, v):
            # one query against every key (the reference sends it to its
            # decode kernel with kv_len=None): the keys' count as the
            # kernel's kv_len, filled on the card (no host sync)
            n = torch.full((1,), k.shape[1], dtype=torch.int32,
                           device=q.device)
            return kops.decode_attention(q, k, v, kv_len=n, window=window)
        if kv_len is None and isinstance(q_offset, int) and q_offset == 0:
            return kops.flash_attention(q, k, v, causal=causal, window=window)
        raise NotImplementedError(
            f"no CUDA attention kernel for q {tuple(q.shape)} with "
            f"causal={causal}, window={window}, q_offset={q_offset!r}, "
            f"kv_len={'set' if kv_len is not None else None}")
    if attn_impl == "chunked" and q.shape[1] > 1 and kv_len is None \
            and isinstance(q_offset, int) and q_offset == 0:
        from repro_torch.models.chunked_attn import chunked_sdpa
        return chunked_sdpa(q, k, v, causal=causal, window=window,
                            q_chunk=q_chunk, packed=packed)
    return sdpa_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                    kv_len=kv_len)


def _chunking(cfg: ModelConfig) -> dict:
    """The config's attention schedule, as :func:`_sdpa` takes it."""
    return {"attn_impl": cfg.attn_impl, "q_chunk": cfg.q_chunk,
            "packed": cfg.packed_causal}


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
              mrope_positions: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over x: [B,S,D].

    Training/prefill: cache_kv=None -> attends within x (returns fresh K/V so
    prefill can populate the cache).
    Decode: cache_kv=(k,v) [B,Smax,Hkv,Dh] and cache_idx = #valid entries
    (an int32 scalar tensor); x is the new token(s). The new K/V are written
    into the cache tensors IN PLACE (the reference returns updated copies),
    and the same tensors are returned. With a window and a cache of exactly
    ``window`` slots, the cache is a ring: slot s holds the newest position
    p with p % window == s, and x is one token. ``mrope_positions`` [3,B,S]
    (the t/h/w streams) replaces RoPE by M-RoPE, its rotary half split as
    the reference splits it.
    """
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q = shard(_split_heads(L.dense(p.q, x), hq), "batch", None,
              "model_heads")
    k = shard(_split_heads(L.dense(p.k, x), hkv), "batch", None, "model_kv")
    v = shard(_split_heads(L.dense(p.v, x), hkv), "batch", None, "model_kv")
    if mrope_positions is not None:
        dh = q.shape[-1]
        sec = (dh // 2 - 2 * (dh // 6), dh // 6, dh // 6)
        q = L.apply_mrope(q, mrope_positions, cfg.rope_theta, sec)
        k = L.apply_mrope(k, mrope_positions, cfg.rope_theta, sec)
    elif cfg.rope_theta > 0:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    if cache_kv is None:
        out = _sdpa(q, k, v, causal=causal, window=window,
                    **_chunking(cfg))
        new_kv = (k, v)
    elif window and cache_kv[0].shape[1] == window:
        # rotating ring-buffer cache for sliding-window decode. The
        # reference masks the unwritten slots, (t >= W) | (slot <= t):
        # exactly the first min(t+1, W) slots, and softmax does not depend
        # on the keys' order, so the decode kernel computes it with kv_len =
        # min(t+1, W); slot and kv_len stay on the device (no host sync)
        ck, cv = cache_kv
        slot = torch.remainder(cache_idx.long(), window).reshape(1)
        cache_write(ck, slot, k)
        cache_write(cv, slot, v)
        kv_len = torch.clamp(cache_idx + 1, max=window)
        out = kops.decode_attention(q, ck, cv, kv_len=kv_len)
        new_kv = (ck, cv)
    else:
        ck, cv = cache_kv
        pos = cache_idx.long() + torch.arange(x.shape[1], device=x.device)
        cache_write(ck, pos, k)
        cache_write(cv, pos, v)
        kv_len = cache_idx + x.shape[1]
        out = _sdpa(q, ck, cv, causal=causal, window=window,
                    q_offset=cache_idx, kv_len=kv_len, **_chunking(cfg))
        new_kv = (ck, cv)
    return shard(p.o(_merge_heads(out)), "batch", None, None), new_kv


def cache_write(cache: torch.Tensor, pos: torch.Tensor,
                new: torch.Tensor) -> None:
    """``cache[:, pos] = new`` in place ([B,Smax,H,Dh] and [B,n,H,Dh]),
    cast to the cache's dtype. On a mesh each rank writes its own shard,
    ``new`` laid out as the cache but whole on its positions; a cache split
    on its sequence (``shardrules.cache_shardings``' long cache whose KV
    heads do not split over "model") takes, on each rank, the positions
    that fall in its slice (:func:`_in_slice`)."""
    new = new.to(cache.dtype)
    if not is_dtensor(cache):
        cache.index_copy_(1, pos, new)
        return
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if pl.is_shard(1) else pl
                 for pl in cache.placements)
    if tuple(new.placements) != want:
        new = new.redistribute(cache.device_mesh, want)
    pos = pos.full_tensor() if is_dtensor(pos) else pos
    local, new = cache.to_local(), new.to_local()
    if want != tuple(cache.placements):
        pos, new = _in_slice(cache, local, pos, new)
    local.index_copy_(1, pos, new)


def _in_slice(cache, local, pos, new):
    """(positions, values) of this rank's write into its slice ``local`` of
    a cache split on its sequence, with no host sync: a position outside
    the slice writes the first inside one's value to that one's place
    instead, or, where none is inside, slot 0's own value back, so that
    every place a copy writes twice gets one value twice."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    off = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, list(cache.placements))[1][1]
    dst = pos.long() - off
    inside = (dst >= 0) & (dst < local.shape[1])
    first = torch.argmax(inside.to(torch.int32))     # 0 where none is
    src = torch.where(inside, torch.arange(len(pos), device=pos.device),
                      first)
    some = inside.any()
    return (torch.where(some, dst[src], 0),
            torch.where(some, new.index_select(1, src), local[:, :1]))


def cross_attention(p: Attention, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor],
                    cfg: ModelConfig, kv_len=None) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (no positions,
    not causal): the flash kernel at prefill and in training (its queries
    fewer than its keys), the decode kernel at a 1-token decode step, which
    passes ``kv_len``, the keys' count as a one-element int32 tensor made
    once with the cache (every key is attended)."""
    q = _split_heads(L.dense(p.q, x), cfg.num_heads)
    k, v = enc_kv
    out = _sdpa(q, k, v, causal=False, kv_len=kv_len, **_chunking(cfg))
    return p.o(_merge_heads(out))


def encode_cross_kv(p: Attention, enc_out: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    k = _split_heads(L.dense(p.k, enc_out), cfg.num_kv_heads)
    v = _split_heads(L.dense(p.v, enc_out), cfg.num_kv_heads)
    return k, v
