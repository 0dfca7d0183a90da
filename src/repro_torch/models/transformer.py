"""Decoder-only LM for the dense, MoE, VLM, SSM and hybrid families: init,
prefill with cache build, one decode step, and the train loss.

PyTorch counterpart of ``repro/models/transformer.py``. The reference
stacks per-layer leaves on a leading [L] axis and runs ``lax.scan`` over
them; here the layers are an ``nn.ModuleList`` and the scan is a loop.
The caches keep the reference's layouts on the model's device, each with
an int32 scalar ``idx``, and decode writes them in place:
  - dense, MoE and VLM: the KV cache ``[L,B,Smax,Hkv,Dh]``;
  - SSM: ``{"conv": [L,B,W-1,Cin], "ssm": [L,B,H,P,N]}``;
  - hybrid (recurrentgemma: ``ng`` groups of the (rec, rec, attn) pattern,
    then ``nt`` tail rec layers): ``{"groups": {"pos{i}": ...}, "tail":
    ...}`` with, per position, the RG-LRU state ``{"conv": [ng,B,W-1,lw],
    "lru": [ng,B,lw]}`` or a ring of K/V ``[ng,B,w,Hkv,Dh]``, w =
    min(window, max_len); the parameters follow the same layout
    (``groups.{g}.pos{i}``, ``tail.{j}``).

One departure from the reference, in the hybrid prefill: it writes its
states into a cache made by :func:`init_cache`, so the conv states and the
K/V ring are in ``cfg.dtype`` and ``lru`` in fp32. The reference returns the
conv state and the ring in the dtype of the (fp32 master) params it
prefilled with, and its bf16 decode then fails (the conv promotes the
branch to fp32, so the layer scan's carry changes dtype: a ``TypeError``).
Its dense prefill casts its K/V to ``cfg.dtype`` the same way. In fp32 the
two agree exactly.

The MoE family's attention blocks hold an expert FFN (``models/moe.py``)
whose load-balancing aux loss each block returns; the stacks sum it over
the layers and :func:`train_loss` adds ``aux_loss_weight`` times the sum.
Granite's multipliers (``ModelConfig``'s ``embedding_multiplier``,
``residual_multiplier``, ``logits_scaling``; the softmax scale
``attention_multiplier`` in ``models/attention.py``) scale the embeddings,
each block's branch and the head's input; at their defaults nothing is
launched for them.
The VLM family reads precomputed patch embeddings (``batch["embeds"]``,
rounded to ``cfg.dtype`` as the reference casts them, then widened to the
params' dtype where they are wider, as JAX promotes) and rotates by M-RoPE
over ``batch["mrope_positions"]`` [3,B,S]; decode broadcasts its position
to the three streams.

Training (:func:`train_loss`) is ported for all five families: the layer
loop with one ``torch.utils.checkpoint`` per scan body when ``cfg.remat``
(the reference's ``jax.checkpoint`` of its scan body: a dense, MoE, VLM or
SSM layer, a hybrid group of (rec, rec, attn), a hybrid tail layer) and the
sequence-chunked cross-entropy (:func:`chunked_xent`). On the card the
scans, the attention and the loss's cross-entropy differentiate through
their backward kernels (``kernels.ops``' autograd Functions). The enc-dec
family is ``models/encdec.py``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (FAMILY_DENSE, FAMILY_HYBRID, FAMILY_MOE,
                                      FAMILY_SSM, FAMILY_VLM, ModelConfig)
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.sharding import current_rules, is_dtensor, shard


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class AttnBlock(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype):
        super().__init__()
        self.ln1 = L.Norm(cfg.d_model, cfg.norm, dtype, gen.device)
        self.attn = A.Attention(gen, cfg, dtype)
        if cfg.d_ff or cfg.moe:
            self.ln2 = L.Norm(cfg.d_model, cfg.norm, dtype, gen.device)
            if cfg.family == FAMILY_MOE:
                self.moe = M.MoE(gen, cfg, dtype)
            else:
                self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, cfg.glu,
                                 cfg.act, dtype)


class SSMBlock(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype):
        super().__init__()
        self.ln1 = L.Norm(cfg.d_model, cfg.norm, dtype, gen.device)
        self.mixer = S.SSDMixer(gen, cfg, dtype)


class RecBlock(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype):
        super().__init__()
        self.ln1 = L.Norm(cfg.d_model, cfg.norm, dtype, gen.device)
        self.mixer = R.RGLRU(gen, cfg, dtype)
        self.ln2 = L.Norm(cfg.d_model, cfg.norm, dtype, gen.device)
        self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, cfg.glu, cfg.act, dtype)


_BLOCKS = {FAMILY_DENSE: AttnBlock, FAMILY_MOE: AttnBlock,
           FAMILY_VLM: AttnBlock, FAMILY_SSM: SSMBlock}
_KINDS = {"rec": RecBlock, "attn": AttnBlock}
PORTED = (FAMILY_DENSE, FAMILY_MOE, FAMILY_VLM, FAMILY_SSM, FAMILY_HYBRID)


def hybrid_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, n_tail) for the hybrid's layer pattern."""
    plen = len(cfg.rglru.pattern)
    return cfg.num_layers // plen, cfg.num_layers % plen


class DecoderLM(nn.Module):
    """Parameters of the decoder of any family but enc-dec (the reference's
    param pytree)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        dtype = getattr(torch, cfg.param_dtype)  # master params
        self.embed = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
        self.final_norm = L.Norm(cfg.d_model, cfg.norm, dtype, gen.device)
        if not cfg.tie_embeddings:
            self.head = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
        if cfg.family == FAMILY_HYBRID:
            ng, nt = hybrid_counts(cfg)
            self.groups = nn.ModuleList(nn.ModuleDict(
                {f"pos{i}": _KINDS[kind](gen, cfg, dtype)
                 for i, kind in enumerate(cfg.rglru.pattern)})
                for _ in range(ng))
            if nt:
                self.tail = nn.ModuleList(RecBlock(gen, cfg, dtype)
                                          for _ in range(nt))
            return
        block = _BLOCKS[cfg.family]
        self.layers = nn.ModuleList(
            block(gen, cfg, dtype) for _ in range(cfg.num_layers))

    def forward(self, fn, *args):
        """``fn(self, *args)``: lets ``torch.func.functional_call`` run any
        of this module's functions with its parameters replaced (the train
        step runs the loss on their casts to ``cfg.dtype``)."""
        return fn(self, *args)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> DecoderLM:
    """Seeded init on ``gen.device``, in ``cfg.param_dtype``."""
    if cfg.family not in PORTED:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return DecoderLM(gen, cfg)


# ---------------------------------------------------------------------------
# blocks (prefill: cache=None; decode: cache per layer)
# ---------------------------------------------------------------------------
def _res(cfg: ModelConfig, x, out):
    """A block's branch added to the residual stream: ``x + out``, or
    ``x + residual_multiplier * out`` in one kernel."""
    r = cfg.residual_multiplier
    return x + out if r == 1.0 else torch.add(x, out, alpha=r)


def _attn_block(p: AttnBlock, x, cfg: ModelConfig, *, positions, window=0,
                cache=None, idx=None, mrope=None):
    """(x, new K/V, the MoE aux loss: the number 0 without experts, so that
    a decode step launches nothing for it)."""
    h = p.ln1(x)
    out, new_kv = A.attention(p.attn, h, cfg, positions=positions,
                              causal=True, window=window, cache_kv=cache,
                              cache_idx=idx, mrope_positions=mrope)
    x = _res(cfg, x, out)
    aux = 0.0
    if hasattr(p, "moe"):
        out, aux = M.moe_ffn(p.moe, p.ln2(x), cfg)
        x = _res(cfg, x, out)
    elif hasattr(p, "mlp"):
        x = _res(cfg, x, p.mlp(p.ln2(x)))
    return x, new_kv, aux


def _ssm_block(p: SSMBlock, x, cfg: ModelConfig, *, cache=None):
    out, new_state = S.ssd_mixer(p.mixer, p.ln1(x), cfg, state=cache)
    return _res(cfg, x, out), new_state


def _rec_block(p: RecBlock, x, cfg: ModelConfig, *, cache=None):
    out, new_state = R.rglru_block(p.mixer, p.ln1(x), cfg, state=cache)
    x = _res(cfg, x, out)
    return _res(cfg, x, p.mlp(p.ln2(x))), new_state


def _hybrid_layers(cfg: ModelConfig, params: DecoderLM, caches):
    """(block, kind, its cache, layer index in that cache) in order: the
    groups' positions, then the tail."""
    for g, group in enumerate(params.groups):
        for i, kind in enumerate(cfg.rglru.pattern):
            key = f"pos{i}"
            yield group[key], kind, caches["groups"][key], g
    for j, lp in enumerate(getattr(params, "tail", ())):
        yield lp, "rec", caches["tail"], j


def _run_stack(cfg: ModelConfig, params: DecoderLM, x, *, positions,
               caches=None, idx=None, mrope=None):
    """Returns (x, caches); decode only, so the MoE aux loss, which the
    reference's decode drops, is not summed. With caches, each layer's slice
    ``caches[...][i]`` (K/V, the SSM conv and ssm states, or the RG-LRU conv
    and lru states) is updated in place."""
    if cfg.family == FAMILY_SSM:      # decode only: prefill has its own loop
        for i, lp in enumerate(params.layers):
            x, st = _ssm_block(lp, x, cfg, cache={
                name: caches[name][i] for name in ("conv", "ssm")})
            for name, t in st.items():
                caches[name][i].copy_(t)
        return x, caches
    if cfg.family == FAMILY_HYBRID:   # decode only, as for the SSM family
        for lp, kind, c, i in _hybrid_layers(cfg, params, caches):
            if kind == "rec":
                x, st = _rec_block(lp, x, cfg, cache={
                    name: c[name][i] for name in ("conv", "lru")})
                for name, t in st.items():
                    c[name][i].copy_(t)
            else:
                x, _, _ = _attn_block(lp, x, cfg, positions=positions,
                                      window=cfg.rglru.window,
                                      cache=(c["k"][i], c["v"][i]), idx=idx)
        return x, caches
    for i, lp in enumerate(params.layers):
        cache = None if caches is None else (caches["k"][i], caches["v"][i])
        x, _, _ = _attn_block(lp, x, cfg, positions=positions, cache=cache,
                              idx=idx, mrope=mrope)
    return x, caches


def _head_table(cfg: ModelConfig, params: DecoderLM) -> nn.Embedding:
    return params.embed if cfg.tie_embeddings else params.head


def _head_input(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm's output as the head product takes it: divided by
    ``logits_scaling`` first (the same logits over it, with no pass over
    [.., V]), unchanged at the default 1."""
    s = cfg.logits_scaling
    return x if s == 1.0 else x * (1.0 / s)


def _logits(cfg: ModelConfig, params: DecoderLM, x: torch.Tensor):
    """The last position's logits of a prefill or decode step."""
    return L.unembed(_head_table(cfg, params), _head_input(cfg, x[:, -1:]))


def _scale_embeds(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _train_attn(cfg: ModelConfig, positions, window, mrope, lp: AttnBlock,
                x, aux):
    """One attention layer of the train stack: x and the running aux loss
    in, both out, so that the aux loss leaves a layer's checkpoint as its
    output does."""
    x, _, a = _attn_block(lp, x, cfg, positions=positions, window=window,
                          mrope=mrope)
    return x, aux + a


def _train_ssm(cfg: ModelConfig, lp: SSMBlock, x):
    return _ssm_block(lp, x, cfg)[0]


def _train_rec(cfg: ModelConfig, lp: RecBlock, x):
    return _rec_block(lp, x, cfg)[0]


def _train_group(cfg: ModelConfig, positions, group: nn.ModuleDict, x):
    """One hybrid group, its (rec, rec, attn) pattern in order; the window
    reaches its attention layers, as in the prefill."""
    for i, kind in enumerate(cfg.rglru.pattern):
        lp = group[f"pos{i}"]
        x = _train_rec(cfg, lp, x) if kind == "rec" else \
            _train_attn(cfg, positions, cfg.rglru.window, None, lp, x, 0.0)[0]
    return x


def _with_aux(fn):
    """A body of x alone as a body of (x, aux) that passes aux through."""
    return lambda x, aux: (fn(x), aux)


def _train_bodies(cfg: ModelConfig, params: DecoderLM, positions, mrope):
    """The reference's scan bodies in order, as functions of (x, aux): a
    layer (dense, MoE, VLM, SSM), or a hybrid group, then each hybrid tail
    layer."""
    P = functools.partial
    if cfg.family == FAMILY_HYBRID:
        return [_with_aux(P(_train_group, cfg, positions, g))
                for g in params.groups] \
            + [_with_aux(P(_train_rec, cfg, lp))
               for lp in getattr(params, "tail", ())]
    if cfg.family == FAMILY_SSM:
        return [_with_aux(P(_train_ssm, cfg, lp)) for lp in params.layers]
    return [P(_train_attn, cfg, positions, 0, mrope, lp)
            for lp in params.layers]


def _run_stack_train(cfg: ModelConfig, params: DecoderLM, x, *, positions,
                     mrope=None):
    """The scan bodies without caches, each under ``torch.utils.checkpoint``
    when ``cfg.remat`` (its activations are recomputed in the backward, as
    ``_maybe_ckpt`` has XLA do). The recompute reads the body's params from
    the module again, so the backward must run while any parameter
    replacement (``functional_call``) is still in place. Returns (x, the
    aux loss summed over the layers)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for fn in _train_bodies(cfg, params, positions, mrope):
        x, aux = checkpoint(fn, x, aux, use_reentrant=False,
                            preserve_rng_state=False) if cfg.remat \
            else fn(x, aux)
    return x, aux


def _xent_chunk(xi: torch.Tensor, table: torch.Tensor, li: torch.Tensor):
    """The chunk's summed loss: on a mesh, the vocabulary slices' terms
    joined (:func:`_vocab_split_terms`); else ``kernels.ops.cross_entropy``
    of the logits as the GEMM gives them (the kernels on the card, which
    compute in fp32 what the cast to fp32 gave; the plain fp32 chain on the
    CPU)."""
    logits = xi @ table.T
    if is_dtensor(logits):
        logz, gold = _vocab_split_terms(
            shard(logits.float(), "batch", None, "model_vocab"), li)
        return torch.sum(logz - gold)
    return torch.sum(kops.cross_entropy(logits, li))


def _vocab_split_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp, the label's logit) of [B,c,V] logits on a mesh, each rank
    working on its own slice of the vocabulary: the slice's logsumexp, one
    a rank, joined by a logsumexp over the ranks; the label's logit where
    it lies in the slice, else 0, summed over the ranks. Only [B,c] terms
    cross ranks: DTensor's own logsumexp and gather of a vocab-split tensor
    would make the [B,c,V] logits whole on every rank first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = logits.device_mesh, list(logits.placements)
    v0 = compute_local_shape_and_global_offset(logits.shape, mesh, pl)[1][2]
    lab_pl = [Replicate() if p == Shard(2) else p for p in pl]
    if list(labels.placements) != lab_pl:
        labels = labels.redistribute(mesh, lab_pl)

    def local(lg, lab):
        i = lab.long() - v0
        mine = (i >= 0) & (i < lg.shape[-1])
        gold = torch.gather(lg, -1, torch.where(mine, i, 0)[..., None])
        return torch.logsumexp(lg, dim=-1, keepdim=True), \
            torch.where(mine, gold[..., 0], 0.0)
    # the slices' logsumexps as a [B,c,ranks] tensor split like the vocab
    lse, gold = local_map(
        local, out_placements=(pl, [Partial() if p == Shard(2) else p
                                    for p in pl]),
        in_placements=(pl, lab_pl), device_mesh=mesh)(logits, labels)
    return torch.logsumexp(lse, dim=-1), gold


def chunked_xent(cfg: ModelConfig, x: torch.Tensor, table: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Sequence-chunked mean cross-entropy. x: [B,S,D]; labels: [B,S].

    Never keeps [B,S,V]: each chunk's logits are computed under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint(body)``)
    and again in the backward, so the peak is [B,chunk,V]. S must be a
    multiple of the chunk, as the reference's reshape needs."""
    table = shard(table, "model_vocab", None)
    b, s, _ = x.shape
    chunk = min(cfg.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"chunked_xent: seq_len {s} is not a multiple of "
                         f"loss_chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s, chunk):
        tot = tot + checkpoint(_xent_chunk, x[:, c:c + chunk], table,
                               labels[:, c:c + chunk], use_reentrant=False,
                               preserve_rng_state=False)
    return tot / (b * s)


def _embed_inputs(cfg: ModelConfig, params: DecoderLM,
                  batch: Dict[str, Any]) -> torch.Tensor:
    """The token embeddings, or the precomputed patch embeddings of an
    ``embed_stub`` config rounded to ``cfg.dtype`` (the reference's cast).
    The layers widen them where the params are wider (``L.dense``)."""
    if cfg.embed_stub:
        x = batch["embeds"].to(_dtype(cfg))
    else:
        # a replicated view of the table (the reference's gather is from
        # one; a no-op without a rule set)
        x = _scale_embeds(cfg, torch.nn.functional.embedding(
            batch["tokens"], shard(params.embed.weight, None, None)))
    return shard(x, "batch", "seq", None)


def _mrope(cfg: ModelConfig, batch: Dict[str, Any]):
    return batch.get("mrope_positions") if cfg.mrope else None


def train_loss(cfg: ModelConfig, params: DecoderLM, batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(mean next-token loss, {"loss", "aux_loss"}) of ``batch`` (tokens, or
    embeds [B,S,D] and mrope_positions [3,B,S], and labels [B,S]) in the
    params' dtype; an MoE config adds ``aux_loss_weight`` times the aux loss
    summed over its layers. The tied table's gradient sums its use as the
    embedding and as the head."""
    x = _embed_inputs(cfg, params, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    x, aux = _run_stack_train(cfg, params, x, positions=positions,
                              mrope=_mrope(cfg, batch))
    x = _head_input(cfg, params.final_norm(x))
    loss = chunked_xent(cfg, x, _head_table(cfg, params).weight,
                        batch["labels"])
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss, {"loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def place_cache(cfg: ModelConfig, cache: Dict[str, Any]) -> Dict[str, Any]:
    """Under a rule set, the cache's tensors (but its scalars) as DTensors
    laid out by ``launch/shardrules.py``'s ``cache_shardings``; without
    one, the cache as it is."""
    rules = current_rules()
    if rules is None:
        return cache
    from repro_torch.launch.shardrules import cache_shardings
    from repro_torch.sharding import from_full

    def place(tree, sh):
        if isinstance(tree, dict):
            return {k: place(v, sh[k]) for k, v in tree.items()}
        if tree is None or tree.dim() == 0:
            return tree
        return from_full(tree, sh.mesh, sh.placements)
    return place(cache, cache_shardings(cfg, rules, cache))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Dict[str, Any]:
    return place_cache(cfg, _init_cache(cfg, batch, max_len, device))


def _init_cache(cfg: ModelConfig, batch: int, max_len: int,
                device) -> Dict[str, Any]:
    idx = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.family == FAMILY_SSM:
        return {"layers": S.init_ssm_state(cfg, batch, cfg.num_layers,
                                           _dtype(cfg), device), "idx": idx}
    if cfg.family == FAMILY_HYBRID:
        ng, nt = hybrid_counts(cfg)
        ring = min(cfg.rglru.window, max_len)
        shape = (ng, batch, ring, cfg.num_kv_heads, cfg.resolved_head_dim)
        groups = {
            f"pos{i}": R.init_rglru_state(cfg, batch, ng, _dtype(cfg), device)
            if kind == "rec" else
            {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
             "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}
            for i, kind in enumerate(cfg.rglru.pattern)}
        tail = R.init_rglru_state(cfg, batch, nt, _dtype(cfg), device) \
            if nt else None
        return {"layers": {"groups": groups, "tail": tail}, "idx": idx}
    cache = A.init_kv_cache(cfg, batch, max_len, _dtype(cfg), cfg.num_layers,
                            device)
    return {"layers": {"k": cache["k"], "v": cache["v"]},
            "idx": cache["idx"]}


def prefill(cfg: ModelConfig, params: DecoderLM, batch: Dict[str, Any],
            max_len: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt, build the decode cache, return last-position logits.

    Runs in the params' dtype (the serve path prefills with the fp32 master
    params, as the reference does). The KV cache is ``cfg.dtype``; the SSM
    states are those the prefill computed (conv in the params' dtype, ssm in
    fp32), as the reference returns them; the hybrid's states are cast to
    the dtypes of :func:`init_cache` (see the module's note). The MoE aux
    loss is dropped, as the reference drops it."""
    x = _embed_inputs(cfg, params, batch)
    if cfg.family == FAMILY_SSM:
        return _ssm_prefill(cfg, params, x)
    if cfg.family == FAMILY_HYBRID:
        return _hybrid_prefill(cfg, params, x, max_len)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :]
    mrope = _mrope(cfg, batch)
    cache = init_cache(cfg, b, max_len, x.device)
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params.layers):
        x, (k, v), _ = _attn_block(lp, x, cfg, positions=positions,
                                   mrope=mrope)
        A.cache_write(ck[i], positions[0], k)
        A.cache_write(cv[i], positions[0], v)
    cache["idx"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    x = params.final_norm(x)
    logits = _logits(cfg, params, x)
    return logits, cache


def _ssm_prefill(cfg: ModelConfig, params: DecoderLM, x
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    b, s = x.shape[:2]
    states = S.init_ssm_state(cfg, b, cfg.num_layers, x.dtype, x.device)
    for i, lp in enumerate(params.layers):
        x, st = _ssm_block(lp, x, cfg)
        for name, t in st.items():
            states[name][i] = t
    cache = {"layers": states,
             "idx": torch.tensor(s, dtype=torch.int32, device=x.device)}
    x = params.final_norm(x)
    return _logits(cfg, params, x), cache


def _hybrid_prefill(cfg: ModelConfig, params: DecoderLM, x, max_len: int
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, max_len, x.device)
    ring = min(cfg.rglru.window, max_len)
    # the last `ring` positions land at slot pos % ring (the ring layout)
    pos = torch.arange(max(0, s - ring), s, device=x.device)
    slots = torch.remainder(pos, ring)
    for lp, kind, c, i in _hybrid_layers(cfg, params, cache["layers"]):
        if kind == "rec":
            x, st = _rec_block(lp, x, cfg)
            for name, t in st.items():
                c[name][i].copy_(t)
        else:
            x, (k, v), _ = _attn_block(lp, x, cfg, positions=positions,
                                       window=cfg.rglru.window)
            A.cache_write(c["k"][i], slots, k[:, pos])
            A.cache_write(c["v"][i], slots, v[:, pos])
    cache["idx"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    x = params.final_norm(x)
    return _logits(cfg, params, x), cache


def decode_step(cfg: ModelConfig, params: DecoderLM, tokens: torch.Tensor,
                cache: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. tokens: [B,1] (or embeds [B,1,D] for a stub
    config). The cache's K/V (or recurrent states) are written in place;
    the returned cache holds them with ``idx + 1``. M-RoPE rotates every
    stream by the step's position."""
    if cfg.embed_stub and tokens.dim() == 3:
        x = tokens.to(_dtype(cfg))
    else:
        x = _scale_embeds(cfg, params.embed(tokens))
    idx = cache["idx"]
    positions = idx[None, None] * torch.ones((x.shape[0], 1),
                                             dtype=torch.int32,
                                             device=x.device)
    mrope = positions[None].expand((3,) + positions.shape) if cfg.mrope \
        else None
    x, new_caches = _run_stack(cfg, params, x, positions=positions,
                               caches=cache["layers"], idx=idx, mrope=mrope)
    x = params.final_norm(x)
    logits = _logits(cfg, params, x)
    return logits, {"layers": new_caches, "idx": idx + 1}
