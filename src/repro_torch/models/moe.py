"""Mixture-of-Experts FFN: top-k router and four dispatch paths.

PyTorch counterpart of ``repro/models/moe.py``, with one path of its own:
- "dense": the all-experts oracle (exact, FLOP-wasteful x E/top_k);
- "sort": the capacity-bounded dispatch, the reference's single-device
  production algorithm (a stable sort by expert gives each token its rank
  among the tokens routed to the same expert; ranks past the capacity are
  dropped); on a mesh whose "model" dim is 1, the whole batch's dispatch
  on every rank;
- EP (when a rule set is installed and the "model" mesh dim is larger than
  1, as the reference decides): :func:`moe_ffn_ep`, ``local_map`` expert
  parallelism with *local* dispatch (the reference's ``shard_map``):
  routing runs on the whole batch's DTensors, each rank scatters its own
  tokens to its own slab of experts, and the partial outputs are summed
  over "model";
- "dropless" (the port's own; single device): every assignment computed,
  as the published models route: each assignment's place in the stable
  sort of the [T,k] expert ids (one scan, :func:`_sorted_positions`)
  groups the assignments by expert, the group ends are a cumsum of the
  counts the aux loss makes (on the card, no host sync), the rows are
  gathered in that order, the expert products run as two grouped GEMMs
  over the groups (``kernels.ops.grouped_mm``), and each assignment's row
  is gathered back by the inverse permutation and summed over the k slots
  with its weight. No capacity, no dropped assignment and no padding
  expert: its layer stores exactly ``num_experts`` experts, gate and up as
  one ``gate_up`` [E, d, 2f] leaf (gate first), ``down`` [E, f, d]. Every
  gather and its backward touches unique rows, and the k slots of a token
  are summed in order (:class:`_Dispatch`): the same bits on every run.
  With :mod:`repro_torch.trace` on it opens the spans ``moe.route``,
  ``moe.dispatch``, ``moe.experts`` and ``moe.combine`` and records the
  counter ``moe.expert_load``.

Expert weights of the other paths are stored padded to a multiple of
``EP_SHARDS`` experts, as the reference stores them (``[E_pad, d, f]``),
so that params and checkpoints cross over unchanged; the padding experts
get no routing mass (the router emits only the true E logits). Their
expert products run as ``torch.bmm`` / ``torch.einsum``, the dropless
path's as PyTorch's grouped GEMM: the reference computes them in XLA, not
in a Pallas kernel.
"""
from __future__ import annotations

import functools
import types
from typing import Tuple

import torch
from torch import nn

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.sharding import (current_rules, flat_rows, from_full,
                                  is_dtensor, placements_for, shard)

EP_SHARDS = 16          # the reference's "model" axis; expert padding unit
CAPACITY_FACTOR = 1.25


def _epad(e: int) -> int:
    return ((e + EP_SHARDS - 1) // EP_SHARDS) * EP_SHARDS


class MoE(nn.Module):
    """The reference's ``moe_init`` leaves, in its layout: ``router`` [d, E]
    (fp32), ``up`` / ``gate`` [E_pad, d, f], ``down`` [E_pad, f, d]. The
    dropless dispatch (GLU experts) stores ``router``, ``gate_up``
    [E, d, 2f] and ``down`` [E, f, d]."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.expert_ff, m.num_experts
        dropless = m.dispatch == "dropless"
        if dropless and not cfg.glu:
            raise NotImplementedError("the dropless dispatch takes GLU "
                                      "experts")
        ep = e if dropless else _epad(e)
        scale = d ** -0.5

        def draw(shape, dt, s):
            t = torch.empty(shape, dtype=dt, device=gen.device)
            with torch.no_grad():
                t.normal_(generator=gen).mul_(s)
            return nn.Parameter(t)

        self.router = draw((d, e), torch.float32, scale)
        if dropless:
            self.gate_up = draw((e, d, 2 * f), dtype, scale)
        else:
            self.up = draw((ep, d, f), dtype, scale)
        self.down = draw((ep, f, d), dtype, f ** -0.5)
        if not dropless:
            self.gate = draw((ep, d, f), dtype, scale) if cfg.glu else None
        # None, or a callable [T,k] expert ids -> [T,k] expert ids that
        # replaces :func:`route`'s top-k choice: a card-vs-CPU check pins
        # one run's routing to another's with it (top-k is discontinuous
        # at a near tie of two experts)
        self.pin = None


def route(p: MoE, x2d: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: returns (weights [T,k] in x's dtype, expert_idx [T,k],
    aux_loss scalar fp32): each token's k likeliest experts, in order, and
    their probabilities renormalised to sum to 1 (``p.pin``, when set,
    replaces the experts, weighed by these probabilities). The logits are
    fp32 whatever the params' dtype (the reference's f32 @ bf16
    promotes)."""
    return _route(p, x2d, cfg)[:3]


def _route(p: MoE, x2d: torch.Tensor, cfg: ModelConfig):
    """:func:`route`'s three, and the [E] fp32 counts of the assignments by
    expert that its aux loss is made of."""
    m = cfg.moe
    logits = x2d.float() @ p.router.float()                     # [T,E]
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, m.top_k, dim=-1)                 # [T,k]
    if p.pin is not None:
        idx = _pinned(p.pin, idx)
        w = probs.gather(-1, idx)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    # load-balancing aux loss (Switch-style): E * sum_e f_e * p_e, f_e the
    # routed fraction: the reference's mean over tokens of the one-hots
    # summed over the k slots, counted here by a scatter (exact: sums of
    # ones), with no [T,k,E] one-hot and no host sync
    me = torch.mean(probs, dim=0)                               # mean prob
    counts = _expert_counts(idx, m.num_experts)
    ce = counts / idx.shape[0]                                  # routed frac
    aux = m.num_experts * torch.sum(me * ce)
    return w.to(x2d.dtype), idx, aux, counts


def _counts(idx: torch.Tensor, e: int) -> torch.Tensor:
    return torch.zeros(e, dtype=torch.float32, device=idx.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=idx.device))


def _expert_counts(idx: torch.Tensor, e: int) -> torch.Tensor:
    """[E] fp32: how many of the [T,k] assignments go to each expert. On a
    mesh each rank counts its own tokens (DTensor has no rule for the
    scatter) and the counts are a sum over the mesh dims that split the
    tokens."""
    if not is_dtensor(idx):
        return _counts(idx, e)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    out = [Partial() if pl == Shard(0) else Replicate()
           for pl in idx.placements]
    if any(pl.is_shard() and pl != Shard(0) for pl in idx.placements):
        idx = idx.redistribute(idx.device_mesh, [
            pl if pl == Shard(0) else Replicate() for pl in idx.placements])
    return local_map(lambda il: _counts(il, e), out_placements=out,
                     in_placements=(list(idx.placements),),
                     device_mesh=idx.device_mesh)(idx)


def _pinned(pin, idx: torch.Tensor) -> torch.Tensor:
    """``pin`` applied to the whole [T,k] ids (a DTensor's gathered, and the
    result put back in its layout)."""
    if not is_dtensor(idx):
        return pin(idx)
    return from_full(pin(idx.full_tensor()), idx.device_mesh, idx.placements)


def _expert_ffn(p: MoE, buf: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """buf: [E, C, D] -> same, by per-expert batched matmuls."""
    e = buf.shape[0]
    h = torch.bmm(buf, p.up[:e])
    if cfg.glu:
        h = L.act_fn(cfg.act)(torch.bmm(buf, p.gate[:e])) * h
    else:
        h = L.act_fn(cfg.act)(h)
    return torch.bmm(h, p.down[:e])


def _rank_in_expert(idx: torch.Tensor) -> torch.Tensor:
    """Each assignment's rank among the assignments to the same expert:
    [T,k] expert ids -> [T,k] ranks.

    The reference ranks one top-k slot at a time (a stable sort of the
    slot's ids, plus the running counts of the earlier slots); that is the
    rank in one stable sort of all assignments in slot-major order, which
    this takes at once: the tokens of one expert rank in (slot, token)
    order, so the capacity drops the same ones. ``torch.argsort`` is stable
    only when asked, as ``jnp.argsort`` always is. A handful of launches
    for all k slots and no host sync (``torch.bincount`` would sync).
    """
    t, k = idx.shape
    flat = idx.T.reshape(-1)                      # slot-major: kk * T + t
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    first = torch.searchsorted(sorted_e, sorted_e)   # its expert's start
    rank_sorted = torch.arange(t * k, device=idx.device) - first
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return rank.reshape(k, t).T


def _dispatch_compute(p: MoE, x2d: torch.Tensor, idx: torch.Tensor,
                      w: torch.Tensor, cfg: ModelConfig, *, e_base: int,
                      e_loc: int, cap: int) -> torch.Tensor:
    """Scatter tokens to the expert slab, run the FFN, gather back.

    x2d: [T,D]; idx/w: [T,k]; the slab covers [e_base, e_base+e_loc). The
    scatter adds x, one top-k slot at a time (no [T*k, D] copy of x), into
    a zeroed slab; every kept destination is unique (an expert's ranks
    never repeat), and the dropped tokens all land on one dump row past the
    slab, which is discarded, so the scatter's order cannot change a kept
    value and a kept row is x itself, as the reference's ``x * keep``
    added to 0 is. Its backward, and the gather's, are gathers and scatters
    onto unique rows: the same bits on every run.
    """
    t, d = x2d.shape
    rank = _rank_in_expert(idx)
    loc = idx - e_base
    keep = (loc >= 0) & (loc < e_loc) & (rank < cap)
    dest = torch.where(keep, loc * cap + rank,
                       torch.full_like(rank, e_loc * cap))     # [T,k]
    buf = torch.zeros((e_loc * cap + 1, d), dtype=x2d.dtype,
                      device=x2d.device)
    for kk in range(idx.shape[1]):
        buf = buf.index_add_(0, dest[:, kk], x2d)
    out_buf = _expert_ffn(p, buf[:-1].reshape(e_loc, cap, d), cfg)
    out_buf = torch.cat([out_buf.reshape(e_loc * cap, d),
                         torch.zeros((1, d), dtype=x2d.dtype,
                                     device=x2d.device)], dim=0)
    gk = w * keep.to(x2d.dtype)                                # [T,k]
    picked = torch.index_select(out_buf, 0, dest.reshape(-1))
    return torch.sum(picked.reshape(t, -1, d) * gk[..., None], dim=1)


def capacity(t: int, cfg: ModelConfig,
             capacity_factor: float = CAPACITY_FACTOR) -> int:
    """Slots per expert for ``t`` tokens: a Python int of the shapes (1 at a
    one-token decode step), as the reference computes it."""
    m = cfg.moe
    return int(max(1, (t * m.top_k * capacity_factor) // m.num_experts))


def moe_ffn_sort(p: MoE, x: torch.Tensor, cfg: ModelConfig,
                 capacity_factor: float = CAPACITY_FACTOR
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device capacity dispatch. x: [B,S,D]."""
    b, s, d = x.shape
    x2d = flat_rows(x)
    w, idx, aux = route(p, x2d, cfg)
    compute = functools.partial(
        _dispatch_compute, cfg=cfg, e_base=0,
        e_loc=_epad(cfg.moe.num_experts),
        cap=capacity(b * s, cfg, capacity_factor))
    if is_dtensor(x2d):
        # on a mesh whose "model" dim is 1: the dispatch of the whole batch
        # on every rank (DTensor has no rule for its sort and search)
        out2d = _replicated(lambda up, gate, down, xl, il, wl: compute(
            types.SimpleNamespace(up=up, gate=gate, down=down), xl, il, wl),
            p.up, p.gate, p.down, x2d, idx, w)
    else:
        out2d = compute(p, x2d, idx, w)
    return out2d.reshape(b, s, d), aux


def _replicated(fn, *args):
    """``fn`` on the whole of its DTensor ``args`` on every rank (None
    passed as it is); its output replicated."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if a is not None).device_mesh
    rep = [Replicate()] * mesh.ndim
    args = [a if a is None or list(a.placements) == rep
            else a.redistribute(mesh, rep) for a in args]
    return local_map(fn, out_placements=rep,
                     in_placements=tuple(None if a is None else rep
                                         for a in args),
                     device_mesh=mesh)(*args)


def moe_ffn_ep(p: MoE, x: torch.Tensor, cfg: ModelConfig,
               capacity_factor: float = CAPACITY_FACTOR
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel path (see the module docstring). x: [B,S,D], a
    DTensor. The expert slabs are split over "model" (each rank's
    ``_epad(E) // model`` experts from ``rank_model * e_loc``); the tokens,
    their weights and ids over the batch dims. Each rank's capacity is
    that of its own tokens, ``(B // dp) * S``, as the reference's."""
    rules = current_rules()
    mesh = rules.mesh
    m = cfg.moe
    b, s, d = x.shape
    x = shard(x, "batch", None, None)
    w, idx, aux = route(p, flat_rows(x), cfg)
    w3 = shard(w.reshape(b, s, m.top_k), "batch", None, None)
    i3 = shard(idx.reshape(b, s, m.top_k), "batch", None, None)

    batch_phys = rules.physical("batch")
    e_loc = _epad(m.num_experts) // mesh["model"].size()
    t_loc = (b // rules.size("batch")) * s
    cap = capacity(t_loc, cfg, capacity_factor)

    from torch.distributed.tensor import Partial
    bspec = (batch_phys, None, None)
    bpl = list(placements_for(mesh, bspec))
    wpl = list(placements_for(mesh, ("model", None, None)))
    names = list(mesh.mesh_dim_names)
    batch_dims = batch_phys if isinstance(batch_phys, tuple) \
        else (batch_phys,)
    # each rank's output is its experts' share of its tokens: a sum over
    # "model"; the gradients of the replicated inputs are sums too (the
    # tokens' over "model", the slabs' over the batch dims)
    out_pl = [Partial() if n == "model" else pl
              for n, pl in zip(names, bpl)]
    wgrad = [Partial() if n in batch_dims else pl
             for n, pl in zip(names, wpl)]

    def local_fn(up, gate, down, xl, wl, il):
        rank_m = mesh.get_local_rank("model")
        bl, sl, dl = xl.shape
        pl_ = types.SimpleNamespace(up=up, gate=gate, down=down)
        out2d = _dispatch_compute(
            pl_, xl.reshape(bl * sl, dl), il.reshape(bl * sl, m.top_k),
            wl.reshape(bl * sl, m.top_k), cfg,
            e_base=rank_m * e_loc, e_loc=e_loc, cap=cap)
        return out2d.reshape(bl, sl, dl)

    from torch.distributed.tensor.experimental import local_map
    slabs = [t if t is None or list(t.placements) == wpl
             else t.redistribute(mesh, wpl) for t in (p.up, p.gate, p.down)]
    fn = local_map(
        local_fn, out_placements=out_pl,
        in_placements=(wpl, wpl if p.gate is not None else None, wpl,
                       bpl, bpl, bpl),
        in_grad_placements=(wgrad, wgrad if p.gate is not None else None,
                            wgrad, out_pl, out_pl, bpl),
        device_mesh=mesh)
    out = fn(*slabs, x, w3, i3)
    return shard(out, "batch", None, None), aux


def moe_ffn_dense(p: MoE, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-experts oracle (exact, no capacity drops)."""
    m = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    w, idx, aux = route(p, x2d, cfg)
    e = m.num_experts
    h = torch.einsum("td,edf->tef", x2d, p.up[:e])
    if cfg.glu:
        h = L.act_fn(cfg.act)(torch.einsum("td,edf->tef", x2d,
                                           p.gate[:e])) * h
    else:
        h = L.act_fn(cfg.act)(h)
    y_all = torch.einsum("tef,efd->ted", h, p.down[:e])         # [T,E,D]
    sel = torch.nn.functional.one_hot(idx, e).to(x.dtype)       # [T,k,E]
    gates = torch.einsum("tk,tke->te", w, sel)                  # [T,E]
    out2d = torch.einsum("te,ted->td", gates, y_all)
    return out2d.reshape(b, s, d), aux


class _Dispatch(torch.autograd.Function):
    """x2d [T,D] -> its rows in the sorted order ``order`` of the [T*k]
    token-major assignments, row i being token ``order[i] // k``. The
    backward puts the rows' gradients back in assignment order (a gather
    by the inverse permutation, unique rows) and sums each token's k slots
    in order: no scatter-add, so the same bits on every run."""

    @staticmethod
    def forward(ctx, x2d, order, inv, k: int):
        ctx.save_for_backward(inv)
        ctx.k = k
        return x2d.index_select(0, torch.div(order, k,
                                             rounding_mode="floor"))

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        gx = g.index_select(0, inv)
        return gx.reshape(-1, ctx.k, g.shape[-1]).sum(1), None, None, None


class _Permute(torch.autograd.Function):
    """Rows ``ys[inv]``, ``inv`` a permutation whose inverse is ``order``;
    the backward gathers ``g[order]``: no scatter."""

    @staticmethod
    def forward(ctx, ys, inv, order):
        ctx.save_for_backward(order)
        return ys.index_select(0, inv)

    @staticmethod
    def backward(ctx, g):
        order, = ctx.saved_tensors
        return g.index_select(0, order), None, None


def _sorted_positions(flat: torch.Tensor, e: int) -> torch.Tensor:
    """Each of the [N] assignments' place in their stable sort by expert
    id: the assignments before it in expert-major, then index order. That
    is one inclusive cumsum of their [E, N] one-hots laid out expert-major
    and read at each one's own entry, less 1: a zero fill, a scatter, one
    device-wide scan and a gather (a sort's kernels copy its keys first)."""
    n = flat.numel()
    at = flat * n + torch.arange(n, device=flat.device)
    hot = torch.zeros(e * n, dtype=torch.int32, device=flat.device)
    hot.scatter_(0, at, 1)
    return torch.cumsum(hot, 0, dtype=torch.int32).index_select(
        0, at).long() - 1


def _expert_products(p: MoE, xs: torch.Tensor, offs: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """The experts' GLU FFN on their groups of sorted rows: [T*k, D] ->
    same, as two grouped products (gate and up in one)."""
    h = kops.grouped_mm(xs, p.gate_up, offs)
    f = h.shape[-1] // 2
    h = L.act_fn(cfg.act)(h[:, :f]) * h[:, f:]
    return kops.grouped_mm(h, p.down, offs)


def moe_ffn_dropless(p: MoE, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless dispatch (see the module docstring). x: [B,S,D], a plain
    tensor on one device."""
    if is_dtensor(x):
        raise NotImplementedError("the dropless MoE dispatch runs on one "
                                  "device; a mesh takes moe_ffn_ep")
    b, s, d = x.shape
    k = cfg.moe.top_k
    x2d = x.reshape(b * s, d)
    with trace.span("moe.route"):
        w, idx, aux, counts = _route(p, x2d, cfg)
    trace.count("moe.expert_load", counts)
    with trace.span("moe.dispatch"):
        inv = _sorted_positions(idx.reshape(-1), cfg.moe.num_experts)
        order = torch.empty_like(inv).scatter_(
            0, inv, torch.arange(inv.numel(), device=x.device))
        offs = torch.cumsum(counts, 0).to(torch.int32)           # [E] ends
        xs = _Dispatch.apply(x2d, order, inv, k)
    with trace.span("moe.experts"):
        ys = _expert_products(p, xs, offs, cfg)
    with trace.span("moe.combine"):
        y = _Permute.apply(ys, inv, order).reshape(b * s, k, d)
        out2d = torch.sum(y * w[..., None], dim=1)
    return out2d.reshape(b, s, d), aux


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe.dispatch == "dense":
        return moe_ffn_dense(p, x, cfg)
    if cfg.moe.dispatch == "dropless":
        return moe_ffn_dropless(p, x, cfg)
    rules = current_rules()
    if rules is not None and "model" in rules.mesh.mesh_dim_names \
            and rules.mesh["model"].size() > 1:
        return moe_ffn_ep(p, x, cfg)
    return moe_ffn_sort(p, x, cfg)
