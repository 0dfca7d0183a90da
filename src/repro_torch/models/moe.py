"""Mixture-of-Experts FFN: top-k router and two dispatch paths.

PyTorch counterpart of ``repro/models/moe.py``:
- "dense": the all-experts oracle (exact, FLOP-wasteful x E/top_k);
- "sort": the capacity-bounded dispatch, the reference's single-device
  production algorithm (a stable sort by expert gives each token its rank
  among the tokens routed to the same expert; ranks past the capacity are
  dropped).

The reference's third path, ``moe_ffn_ep`` (``shard_map`` expert
parallelism), needs a mesh, which the port does not have yet (ROADMAP
Queue 1, multi-GPU); :func:`moe_ffn` picks dense or sort by
``cfg.moe.dispatch``.

Expert weights are stored padded to a multiple of ``EP_SHARDS`` experts, as
the reference stores them (``[E_pad, d, f]``), so that params and
checkpoints cross over unchanged; the padding experts get no routing mass
(the router emits only the true E logits). The expert products run as
``torch.bmm`` / ``torch.einsum``: the reference computes them in XLA, not
in a Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

EP_SHARDS = 16          # the reference's "model" axis; expert padding unit
CAPACITY_FACTOR = 1.25


def _epad(e: int) -> int:
    return ((e + EP_SHARDS - 1) // EP_SHARDS) * EP_SHARDS


class MoE(nn.Module):
    """The reference's ``moe_init`` leaves, in its layout: ``router`` [d, E]
    (fp32), ``up`` / ``gate`` [E_pad, d, f], ``down`` [E_pad, f, d]."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.expert_ff, m.num_experts
        ep = _epad(e)
        scale = d ** -0.5

        def draw(shape, dt, s):
            t = torch.empty(shape, dtype=dt, device=gen.device)
            with torch.no_grad():
                t.normal_(generator=gen).mul_(s)
            return nn.Parameter(t)

        self.router = draw((d, e), torch.float32, scale)
        self.up = draw((ep, d, f), dtype, scale)
        self.down = draw((ep, f, d), dtype, f ** -0.5)
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
    m = cfg.moe
    logits = x2d.float() @ p.router.float()                     # [T,E]
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, m.top_k, dim=-1)                 # [T,k]
    if p.pin is not None:
        idx = p.pin(idx)
        w = probs.gather(-1, idx)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    # load-balancing aux loss (Switch-style): E * sum_e f_e * p_e, f_e the
    # routed fraction: the reference's mean over tokens of the one-hots
    # summed over the k slots, counted here by a scatter (exact: sums of
    # ones), with no [T,k,E] one-hot and no host sync
    me = torch.mean(probs, dim=0)                               # mean prob
    ce = torch.zeros(m.num_experts, dtype=torch.float32,
                     device=x2d.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=x2d.device)
    ) / idx.shape[0]                                            # routed frac
    aux = m.num_experts * torch.sum(me * ce)
    return w.to(x2d.dtype), idx, aux


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
    x2d = x.reshape(b * s, d)
    w, idx, aux = route(p, x2d, cfg)
    out2d = _dispatch_compute(p, x2d, idx, w, cfg, e_base=0,
                              e_loc=_epad(cfg.moe.num_experts),
                              cap=capacity(b * s, cfg, capacity_factor))
    return out2d.reshape(b, s, d), aux


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


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe.dispatch == "dense":
        return moe_ffn_dense(p, x, cfg)
    return moe_ffn_sort(p, x, cfg)
