"""Launchers of the CUDA flash attention: the forward
(``csrc/flash_attention.cu``, and ``csrc/flash_attention_sm90.cu`` for the
bf16 calls at width 64) and its backward (``csrc/flash_attention_bwd.cu``).

The forward replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``_fa_kernel`` / ``flash_attention_fwd``). The backward has no Pallas
counterpart: the reference differentiates its plain attention with XLA's
autodiff. The source notes in the ``.cu`` files say what bounds each kernel
on the card and how its design answers that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library


def _check(name, q, k, v, max_dh):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in library.DTYPE_CODES:
        raise TypeError(f"{name}: q/k/v must share dtype float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: expected q [B,S,Hq,dh], k/v [B,Skv,Hkv,dh]")
    b, sq, hq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % k.shape[2] or dh > max_dh:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} (dh <= {max_dh})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        return_lse: bool = False, scale=None):
    """q: [B,S,Hq,dh]; k/v: [B,Skv,Hkv,dh]; contiguous CUDA tensors of one
    dtype (fp32 or bf16), dh <= 256. A call that :func:`takes_sm90` (bf16
    at width 64) runs ``csrc/flash_attention_sm90.cu``; any other the kernel
    of ``csrc/flash_attention.cu`` at the next width of 64/128/256, which
    reads the missing head dims as zeros. The softmax scale is ``scale``,
    None for the true ``dh ** -0.5``. With ``return_lse`` it
    returns ``(o, lse)``, lse [B,Hq,S] fp32 the natural-log log-sum-exp of
    each row's scaled logits (+inf for a row that sees no key), which the
    backward needs.

    Forward only: with grad enabled and an input that requires grad it
    raises; :class:`~repro_torch.kernels.flash_attention.ops.FlashAttentionFn`
    (through ``kernels.ops.flash_attention``) is the differentiable call."""
    library.refuse_grad("flash_attention", q, k, v,
                        item="train through kernels.ops.flash_attention")
    library.require_cuda("flash_attention", q, k, v)
    _check("flash_attention", q, k, v, 256)
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    sm90 = takes_sm90(q, k, v, scale)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, b, sq, skv, hq, hkv)
    with torch.cuda.device(q.device):
        if sm90:
            library.launch("flash_attention_sm90_launch", *args,
                           int(bool(causal)), int(window),
                           _softmax_scale(dh, scale), library.stream_of(q))
        else:
            library.launch("flash_attention_launch", *args, dh,
                           int(bool(causal)), int(window),
                           _softmax_scale(dh, scale),
                           library.DTYPE_CODES[q.dtype], library.stream_of(q))
    flash_attention_fwd.launches += 1
    flash_attention_fwd.sm90_launches += int(sm90)
    return (out, lse) if return_lse else out


# every launch of the forward, and those of them on the sm90 route
flash_attention_fwd.launches = 0
flash_attention_fwd.sm90_launches = 0


def takes_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale=None) -> bool:
    """Whether a forward goes to ``csrc/flash_attention_sm90.cu`` rather
    than ``csrc/flash_attention.cu``: bf16 at head width 64, q/k/v at
    16-byte aligned addresses (the tensor maps' rule), at least one key and
    a positive softmax scale (its softmax takes the row maximum of the raw
    scores); any mask, length or GQA ratio. A function of what the wrapper
    sees in its inputs alone."""
    return (q.dtype == torch.bfloat16 and q.shape[3] == 64
            and k.shape[1] > 0 and _softmax_scale(64, scale) > 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def _softmax_scale(dh: int, scale) -> float:
    return float(dh ** -0.5 if scale is None else scale)


# the backward's dK/dV kernel has one block per key tile of BWD_KEY_TILE
# keys (kTile in csrc/flash_attention_bwd.cu; 32 for fp32 at width 256),
# batch, KV head, run of query heads and, past width 128, half of the head
# dims (BwdCfg::NH); it fills an H100 with two blocks for each of its 132 SMs, so that
# the causal mask's uneven tiles even out
BWD_KEY_TILE = 64
BWD_BLOCKS_WANTED = 2 * 132


def bwd_heads_per_split(b: int, skv: int, hq: int, hkv: int, dh: int = 128,
                        fp32: bool = False) -> int:
    """How many of a group's ``hq // hkv`` query heads one block of the
    backward's dK/dV kernel walks: all of them when the (key tile, batch, KV
    head, half) blocks already number ``BWD_BLOCKS_WANTED``, else g / r
    rounded up, for the r runs that would bring the blocks up to it (at most
    one head a block). Rounding up keeps every run but the last equal and
    the blocks at least half of what was wanted. In fp32 at width 256 (the
    check route) every head is a run of its own: a block's fp32
    accumulators then sum at most S terms (16 heads x 2048 queries in one
    run missed the 1e-4 limit at the key every query sees). A pure function
    of the shapes, at least 1; the last run may be shorter than the
    others."""
    g = hq // hkv
    wide = dh > 128
    if wide and fp32:
        return 1
    blocks = max(1, b * hkv * -(-skv // BWD_KEY_TILE) * (2 if wide else 1))
    runs = min(g, -(-BWD_BLOCKS_WANTED // blocks))
    return -(-g // runs)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0, scale=None):
    """(dq, dk, dv) in q's dtype of the attention whose forward gave ``o``
    and ``lse`` (:func:`flash_attention_fwd` with ``return_lse``, at the
    same ``scale``), for the output gradient ``do``; all contiguous CUDA
    tensors, q/k/v/o/do of one dtype (fp32 or bf16), lse fp32 [B,Hq,S],
    dh <= 256. Kernels on the
    caller's stream: D = rowsum(do * o), then dk/dv (with the group's query
    heads in :func:`bwd_heads_per_split` runs, whose fp32 partials a
    second kernel adds in order when there is more than one), then dq; no
    atomics, so repeats are bit-identical. Its outputs have no gradient
    path either, so with grad enabled (a double backward) it raises on
    inputs that require grad."""
    library.refuse_grad("flash_attention_bwd", q, k, v, o, do,
                        item="a double backward through flash attention is "
                        "not ported")
    library.require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    _check("flash_attention_bwd", q, k, v, 256)
    if o.shape != q.shape or do.shape != q.shape or \
            o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: o and do must be like q")
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if lse.dtype != torch.float32 or lse.shape != (b, hq, sq):
        raise ValueError(f"flash_attention_bwd: lse must be fp32 "
                         f"{(b, hq, sq)}, got {lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    hps = bwd_heads_per_split(b, skv, hq, hkv, dh,
                              q.dtype == torch.float32)
    splits = -(-(hq // hkv) // hps)
    part = torch.empty(2 * splits * b * skv * hkv * dh, dtype=torch.float32,
                       device=q.device) if splits > 1 else None
    with torch.cuda.device(q.device):
        library.launch("flash_attention_bwd_launch", q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                       lse.data_ptr(), delta.data_ptr(),
                       part.data_ptr() if part is not None else None,
                       dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv,
                       hq, hkv, dh, int(bool(causal)), int(window), hps,
                       _softmax_scale(dh, scale), library.DTYPE_CODES[q.dtype],
                       library.stream_of(q))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
