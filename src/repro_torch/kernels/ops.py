"""Dispatch for the port's kernels, by the tensors' device and layout.

Mirrors ``repro/kernels/ops.py`` of the reference package without its
switches: a CUDA tensor always goes to the hand-written Hopper kernel (or
the call raises), a CPU tensor to the kernel's plain PyTorch version. There
is no environment switch and no fallback from the card to the plain
version.

Given DTensors, the attention and scan wrappers run through ``local_map``
(the reference's ``shard_map``): batch rows over the rule set's "batch"
mesh dims and heads (or channels) over "model", where the sizes divide;
an input in any other layout is redistributed to that one first, as GSPMD
gathers around a custom call it cannot partition (a KV cache sharded on its
sequence, for example). Each rank then launches the same kernel on its own
rows and heads, through the dispatch above: no sharded path falls back to
the plain version on the card.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

from repro_torch.kernels.cross_entropy.ops import cross_entropy  # noqa: F401
from repro_torch.kernels.decode_attention.ops import \
    decode_attention as _decode_attention
from repro_torch.kernels.flash_attention.ops import \
    flash_attention as _flash_attention
from repro_torch.kernels.rglru_scan.ops import rglru_scan as _rglru_scan
from repro_torch.kernels.ssd_scan.ops import ssd_scan as _ssd_scan
from repro_torch.kernels.wq_claim.ops import wq_claim, wq_claim_columns  # noqa: F401
from repro_torch.sharding import (axis_sizes, current_rules, is_dtensor,
                                  placements_for)


def _batch_axes(mesh, n: int) -> Tuple[str, ...]:
    """The mesh dims that shard ``n`` batch rows: the rule set's "batch"
    dims (or every dim but "model" without rules), dropped from the last
    while they do not divide ``n``."""
    rules = current_rules()
    sizes = axis_sizes(mesh)
    if rules is not None:
        phys = rules.physical("batch")
        axes = tuple(phys) if isinstance(phys, tuple) else \
            ((phys,) if phys else ())
    else:
        axes = tuple(a for a in sizes if a != "model")
    while axes:
        total = 1
        for a in axes:
            total *= sizes[a]
        if n % total == 0:
            return axes
        axes = axes[:-1]
    return ()


def _model(mesh, batch_axes, *counts: int) -> Optional[str]:
    """"model" when the mesh has it, the batch does not use it, and it
    divides every count; else None."""
    m = axis_sizes(mesh).get("model", 1)
    if m > 1 and "model" not in batch_axes and all(c % m == 0
                                                   for c in counts):
        return "model"
    return None


def on_mesh(fn: Callable, args: Sequence[Any], specs: Sequence[Any],
            out_specs, mesh, partial_grads: Sequence[int] = ()):
    """``fn`` on each rank's shards of ``args``: the DTensors among them
    redistributed to ``specs`` (one per arg; None for an argument passed
    whole), the outputs DTensors of ``out_specs`` (a spec, or a list of
    them). The gradient of each arg in ``partial_grads`` is a sum over the
    mesh dims its spec leaves replicated (each rank's share of it comes
    from its own shard of the outputs)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    in_pl, call = [], []
    for a, s in zip(args, specs):
        if s is None:
            if isinstance(a, DTensor):
                a = a.full_tensor()
            in_pl.append(None)
        else:
            want = placements_for(mesh, s)
            if not isinstance(a, DTensor):
                raise TypeError("on_mesh: a sharded argument must be a "
                                "DTensor")
            if tuple(a.placements) != want:
                a = a.redistribute(mesh, want)
            in_pl.append(list(want))
        call.append(a)
    # local_map reads a tuple as one layout per output, a list as one
    # output's layout
    out_pl = tuple(list(placements_for(mesh, s)) for s in out_specs) \
        if isinstance(out_specs, list) else list(placements_for(mesh,
                                                                out_specs))
    grad_pl = [None if pl is None else
               [Partial() if i in partial_grads and p == Replicate() else p
                for p in pl] for i, pl in enumerate(in_pl)]
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*call)


def _attn_specs(q, k):
    """(q's spec, k's and v's spec, the output's) for attention on a mesh:
    batch over the batch dims, heads over "model" when both head counts
    divide, or when the queries' do and there is one K/V head (MQA: every
    query head's K/V is that one)."""
    mesh = q.device_mesh
    b = _batch_axes(mesh, q.shape[0])
    hq, hkv = q.shape[2], k.shape[2]
    mq = _model(mesh, b, hq, hkv)
    mkv = mq
    if mq is None and hkv == 1:
        mq = _model(mesh, b, hq)
    bb = b or None
    return (bb, None, mq, None), (bb, None, mkv, None)


def attention_on_mesh(fn: Callable, q, k, v, *extra):
    """``fn(q, k, v, *extra)`` (an attention on [B,S,H,Dh] tensors) on each
    rank's batch rows and heads; ``extra`` (kv_len, offsets) replicated."""
    qs, kvs = _attn_specs(q, k)
    # K/V whole over "model" while the queries' heads are split: each
    # rank's K/V gradient is its heads' share
    mqa = (1, 2) if qs[2] is not None and kvs[2] is None else ()
    return on_mesh(fn, (q, k, v, *extra), (qs, kvs, kvs) + (None,) *
                   len(extra), qs, q.device_mesh, partial_grads=mqa)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,S,Hq,DH]; k/v: [B,Skv,Hkv,DH]."""
    if is_dtensor(q):
        return attention_on_mesh(lambda a, b, c: _flash_attention(
            a, b, c, causal=causal, window=window), q, k, v)
    return _flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, *, kv_len, window: int = 0):
    """q: [B,1,Hq,DH]; k/v: [B,Smax,Hkv,DH]; kv_len: int32 tensor of one
    element."""
    if is_dtensor(q):
        return attention_on_mesh(lambda a, b, c, n: _decode_attention(
            a, b, c, kv_len=n, window=window), q, k, v, kv_len)
    return _decode_attention(q, k, v, kv_len=kv_len, window=window)


def _ssd_rows(mesh, groups: int) -> Tuple[str, ...]:
    """Mesh dims (batch dims, then "model") that split ``groups`` groups of
    [BH] rows, each sharing its B and C (``heads_per_bc`` rows), into whole
    groups."""
    sizes = axis_sizes(mesh)
    axes = _batch_axes(mesh, groups)
    n = 1
    for a in axes:
        n *= sizes[a]
    m = sizes.get("model", 1)
    if "model" not in axes and m > 1 and groups % (n * m) == 0:
        axes = axes + ("model",)
    return axes


def ssd_scan(x, bmat, cmat, dt, da, *, chunk: int = 256,
             heads_per_bc: int = 1):
    """x: [BH,S,P]; bmat/cmat: [BH/heads_per_bc,S,N]; dt/da: [BH,S(,1)].
    Returns (y [BH,S,P], final state [BH,P,N] fp32). On a mesh, the rows
    are split in whole groups of ``heads_per_bc``."""
    if is_dtensor(x):
        rows = _ssd_rows(x.device_mesh, bmat.shape[0]) or None
        r3 = (rows, None, None)
        rdt = (rows,) + (None,) * (dt.ndim - 1)
        return on_mesh(
            lambda *a: _ssd_scan(*a, chunk=chunk, heads_per_bc=heads_per_bc),
            (x, bmat, cmat, dt, da), (r3, r3, r3, rdt, rdt), [r3, r3],
            x.device_mesh)
    return _ssd_scan(x, bmat, cmat, dt, da, chunk=chunk,
                     heads_per_bc=heads_per_bc)


def rglru_scan(a, u):
    """a, u: [B,S,C] -> h [B,S,C]: batch over the batch dims, channels over
    "model" on a mesh."""
    if is_dtensor(a):
        mesh = a.device_mesh
        b = _batch_axes(mesh, a.shape[0])
        spec = (b or None, None, _model(mesh, b, a.shape[2]))
        return on_mesh(_rglru_scan, (a, u), (spec, spec), spec, mesh)
    return _rglru_scan(a, u)
