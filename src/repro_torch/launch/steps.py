"""Train and serve step builders (the reference's ``launch/steps.py``).

Train: ``make_train_step(cfg)`` returns ``(state, batch, knobs) ->
(state, metrics)``. The loss and its gradients are computed at
``cfg.dtype`` against the fp32 master params: the masters are cast by a
differentiable ``p.to(cfg.dtype)`` put in place with
``torch.func.functional_call`` (the reference's ``_cast_params_pinned``), so
the gradients land on the masters, the tied table's two uses summed. Then
the step accumulates microbatches, clips by the global norm (folded into
the update as ``gscale``), optionally int8-compresses the gradients with
error feedback, and applies AdamW or Adafactor. The state's tensors are
updated in place (the reference returns new arrays) and the same state is
returned.

Serve: the reference casts the fp32 master params to ``cfg.dtype`` inside
every serve step. Here the caller holds one copy of the params in
``cfg.dtype`` (:func:`cast_params`, made once) and passes it to the step,
which computes the same thing without a cast per token.

On a mesh (``rules``, the reference's argument of the same name): the
params and the optimizer state are DTensors laid out by
``launch/shardrules.py`` (:func:`init_train_state` with ``rules``, or
:func:`distribute_train_state` of given masters); a step places plain
inputs by the batch's shardings (the reference's jit ``in_shardings``)
and runs under the rule set; each gradient is laid out as its master
before the update (once a step, after the microbatches); the metrics and
the serve steps' tokens and log-probs come back whole on every rank.
"""
from __future__ import annotations

import copy
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.sharding import place_batch
from repro_torch.interop import reference_leaves
from repro_torch.launch import shardrules as SR
from repro_torch.models.registry import (build_model, decode_input_specs,
                                         prefill_input_specs,
                                         train_input_specs)
from repro_torch.optim import apply_updates, init_opt
from repro_torch.optim.clipping import global_norm
from repro_torch.optim.compression import compress_grads, init_error
from repro_torch.sharding import (Rules, from_full, full_tensor, is_dtensor,
                                  use_rules, zeros)


def copy_params(params: nn.Module, fn) -> nn.Module:
    """A copy of ``params`` whose every parameter is ``fn(parameter)``.

    The copy is made parameter by parameter: each parameter is mapped on
    its own and handed to ``copy.deepcopy`` as that parameter's copy, so no
    second copy of the params as they were ever exists (at
    recurrentgemma-9b a second fp32 copy would be 34 GB more on the card)."""
    memo = {id(p): nn.Parameter(fn(p.detach()), requires_grad=p.requires_grad)
            for p in params.parameters()}
    return copy.deepcopy(params, memo)


def cast_params(params: nn.Module, dtype) -> nn.Module:
    """``params`` with floating leaves in ``dtype``: the same module when they
    already are, else a cast copy (:func:`copy_params`; the master copy is
    left as it is)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if all(p.dtype == dt for p in params.parameters()
           if p.is_floating_point()):
        return params
    return copy_params(params, lambda t: t.to(
        dt if t.is_floating_point() else t.dtype, copy=True))


def place_inputs(cfg: ModelConfig, rules: Optional[Rules],
                 batch: Dict[str, Any]) -> Dict[str, Any]:
    """The plain tensors of ``batch`` as DTensors of the batch's shardings
    (``SR.batch_shardings``), each rank keeping its rows; DTensors, and
    everything without a rule set, as they are."""
    if rules is None:
        return batch
    plain = {k: v for k, v in batch.items()
             if torch.is_tensor(v) and not is_dtensor(v) and v.dim() > 0}
    return {**batch, **place_batch(plain, SR.batch_shardings(cfg, rules,
                                                             plain))}


def make_serve_step(cfg: ModelConfig, rules: Optional[Rules] = None,
                    temperature: float = 0.0):
    """(params, tokens, cache, generator) -> (next_tokens, cache, logprobs).

    ``params`` in ``cfg.dtype`` (see :func:`cast_params`); greedy at
    temperature 0, else sampled with ``generator``. With ``rules``: params
    and cache laid out on the mesh, the tokens placed over the batch; the
    new tokens and log-probs whole on every rank."""
    model = build_model(cfg)

    @torch.no_grad()
    def step(params, tokens, cache, generator: Optional[torch.Generator] = None):
        with use_rules(rules):
            tokens = place_inputs(cfg, rules, {"tokens": tokens})["tokens"]
            logits, new_cache = model.decode_step(params, tokens, cache)
            logits = full_tensor(logits[:, -1]).float()
            if temperature > 0:
                nxt = torch.multinomial(
                    torch.softmax(logits / temperature, -1), 1,
                    generator=generator)[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)
            lp = torch.log_softmax(logits, dim=-1)
            sel = torch.gather(lp, -1, nxt[:, None])[:, 0]
            return nxt[:, None].to(torch.int32), new_cache, sel

    return step


def make_prefill_step(cfg: ModelConfig, rules: Optional[Rules],
                      max_len: int):
    """(params, batch) -> (first generated token [B,1], cache), with
    ``params`` in the dtype to prefill in (the reference casts to
    ``cfg.dtype`` inside the step; its executor prefills with the fp32
    masters). With ``rules``: the batch placed over the batch dims, the
    cache laid out by ``SR.cache_shardings``, the token whole on every
    rank."""
    model = build_model(cfg)

    @torch.no_grad()
    def step(params, batch):
        with use_rules(rules):
            logits, cache = model.prefill(
                params, place_inputs(cfg, rules, batch), max_len)
            logits = full_tensor(logits[:, -1])
        return torch.argmax(logits, -1)[:, None].to(torch.int32), cache

    return step


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
def lay_out_grads(params: nn.Module, grads: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """On a mesh, each gradient laid out as its master (a partial sum
    reduced, a whole one sliced); plain tensors as they are."""
    named = dict(params.named_parameters())
    return {n: g.redistribute(named[n].device_mesh, named[n].placements)
            if is_dtensor(g) and tuple(g.placements) != tuple(
                named[n].placements) else g for n, g in grads.items()}


def loss_and_grads(cfg: ModelConfig, params: nn.Module,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """(loss, metrics, grads): ``train_loss`` on the master ``params`` cast
    to ``cfg.dtype`` and its gradients with respect to the masters, by
    parameter name. The backward runs inside the ``functional_call``, so
    that remat's recompute reads the casts too. On a mesh the loss and the
    metrics are whole on every rank, and the gradients as autograd gives
    them (partial sums among them: :func:`lay_out_grads` lays them out)."""
    model = build_model(cfg)
    dt = getattr(torch, cfg.dtype)
    names, masters = zip(*params.named_parameters())

    def run(lm, b):
        loss, metrics = model.train_loss(lm, b)
        loss = full_tensor(loss)
        grads = dict(zip(names, torch.autograd.grad(loss, masters)))
        return loss.detach(), {k: full_tensor(v).detach()
                               for k, v in metrics.items()}, grads

    cast = {n: p.to(dt) if p.is_floating_point() else p
            for n, p in zip(names, masters)}
    with torch.enable_grad():
        return functional_call(params, cast, (run, batch))


def _micro(batch: Dict[str, torch.Tensor], mb: int, i: int):
    """Microbatch ``i`` of ``mb``: rows [i B/mb, (i + 1) B/mb) of every
    input (the reference's ``_split_micro``: ``[B] -> [mb, B/mb]``; the
    M-RoPE positions ``[3,B,S]`` carry the batch at dim 1)."""
    out = {}
    for k, x in batch.items():
        dim = 1 if k == "mrope_positions" else 0
        if x.shape[dim] % mb:
            raise ValueError(f"batch {k} {tuple(x.shape)} does not split "
                             f"into {mb} microbatches")
        n = x.shape[dim] // mb
        out[k] = x.narrow(dim, i * n, n)
    return out


def make_train_step(cfg: ModelConfig, rules: Optional[Rules] = None,
                    grad_compression: bool = False):
    """(state, batch, knobs) -> (state, metrics).

    state = {"params": the master module, "opt", "err"?}; batch = the
    family's inputs (``data.pipeline.batch_for``: tokens or embeds and
    mrope_positions, or frames and tokens; labels) on the params' device;
    knobs = {"lr": float}. With ``rules``, the state laid out on the mesh
    (see the module's docstring)."""

    def step(state, batch, knobs):
        with use_rules(rules):
            return _train_step(state, batch, knobs)

    def _train_step(state, batch, knobs):
        params = state["params"]
        mb = max(1, cfg.microbatches)
        if mb == 1:
            loss, metrics, grads = loss_and_grads(
                cfg, params, place_inputs(cfg, rules, batch))
            grads = lay_out_grads(params, grads)
        else:
            # gradient accumulation: one microbatch's activations at a time,
            # the sum kept in the first microbatch's gradients (in place:
            # no third set of gradients, 10.6 GB at recurrentgemma-9b's
            # 8-layer cut); on a mesh the sums stay partial until the last
            # microbatch's are in: one reduction a step
            # each microbatch is cut from the whole batch and placed alone
            batch = {k: full_tensor(v) for k, v in batch.items()}
            grads, losses, mets = None, [], []
            for i in range(mb):
                l_, m_, g_ = loss_and_grads(
                    cfg, params, place_inputs(cfg, rules, _micro(batch, mb, i)))
                if grads is None:
                    grads = g_
                else:
                    torch._foreach_add_(list(grads.values()),
                                        [g_[n] for n in grads])
                del g_
                losses.append(l_)
                mets.append(m_)
            grads = lay_out_grads(params, grads)
            torch._foreach_div_(list(grads.values()), float(mb))
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        with torch.no_grad():
            gnorm = global_norm(grads)
            gscale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12),
                                 max=1.0)
            if grad_compression:
                grads, new_err = compress_grads(grads, state["err"],
                                                reference_leaves(params))
            params, new_opt, stats = apply_updates(
                cfg, params, grads, state["opt"], knobs["lr"], gscale=gscale)
        out = {"params": params, "opt": new_opt}
        if grad_compression:
            out["err"] = new_err
        return out, dict(metrics, loss=loss, grad_norm=full_tensor(gnorm),
                         **stats)

    return step


def init_train_state(cfg: ModelConfig, gen: torch.Generator,
                     grad_compression: bool = False,
                     rules: Optional[Rules] = None,
                     device=None) -> Dict[str, Any]:
    """Master params from ``gen`` (on its device) and a fresh optimizer
    state; ``err`` (zeros) with ``grad_compression``. With ``rules``, laid
    out on the mesh by :func:`train_state_shardings`, each rank's shards
    on ``device``: ``gen`` (a CPU generator, the same seed on every rank)
    draws every master on the CPU, as one device would, and each rank
    keeps its shard of each, parameter by parameter, so that no rank
    holds the whole model on its device."""
    params = build_model(cfg).init(gen).requires_grad_(True)
    if rules is not None:
        return distribute_train_state(cfg, rules, params, grad_compression,
                                      device)
    state = {"params": params, "opt": init_opt(cfg, params)}
    if grad_compression:
        state["err"] = init_error(params)
    return state


def train_state_shardings(cfg: ModelConfig, rules: Rules, state) -> Any:
    """The state's shardings: params by ``SR.param_shardings``, the
    optimizer state by ``SR.opt_shardings``, ``err`` as the params."""
    out = {"params": SR.param_shardings(cfg, rules, state["params"]),
           "opt": SR.opt_shardings(cfg, rules, state["params"],
                                   state["opt"])}
    if "err" in state:
        out["err"] = dict(out["params"])
    return out


def distribute_params(cfg: ModelConfig, rules: Rules, params: nn.Module,
                      device=None) -> nn.Module:
    """``params`` with every parameter replaced, one at a time, by a
    DTensor of its sharding holding this rank's shard on ``device`` (the
    module's own tensors are dropped as they are replaced)."""
    shardings = SR.param_shardings(cfg, rules, params)
    for mname, mod in params.named_modules():
        for pname, p in list(mod._parameters.items()):
            if p is None:
                continue
            sh = shardings[f"{mname}.{pname}" if mname else pname]
            mod._parameters[pname] = nn.Parameter(
                from_full(p.detach(), sh.mesh, sh.placements, device),
                requires_grad=p.requires_grad)
    return params


def distribute_train_state(cfg: ModelConfig, rules: Rules,
                           params: nn.Module,
                           grad_compression: bool = False,
                           device=None) -> Dict[str, Any]:
    """A fresh train state on the mesh from master ``params`` whole on
    every rank: the params by :func:`distribute_params`; the optimizer
    state (and ``err``) zeros, each tensor a DTensor of its sharding, each
    rank allocating its own shard alone. ``step`` stays a plain scalar."""
    meta = copy_params(params, lambda t: torch.empty_like(t, device="meta"))
    opt = init_opt(cfg, meta)
    shardings = train_state_shardings(
        cfg, rules, {"params": meta, "opt": opt,
                     **({"err": None} if grad_compression else {})})
    dev = device if device is not None else next(params.parameters()).device
    params = distribute_params(cfg, rules, params, device)

    def zeros_like(tree, sh):
        if isinstance(tree, dict):
            return {k: zeros_like(v, sh[k]) for k, v in tree.items()}
        return zeros(tree.shape, tree.dtype, sh, dev)

    out = {"params": params,
           "opt": {"step": torch.zeros((), dtype=torch.int32, device=dev),
                   "inner": zeros_like(opt["inner"],
                                       shardings["opt"]["inner"])}}
    if grad_compression:
        out["err"] = {n: zeros(p.shape, torch.float32, shardings["err"][n],
                               dev) for n, p in meta.named_parameters()}
    return out


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so that ``init_params``
    builds its tensors there (no storage; the draws do nothing)."""

    @property
    def device(self):
        return torch.device("meta")


def abstract_train_state(cfg: ModelConfig, grad_compression: bool = False
                         ) -> Dict[str, Any]:
    """The train state's shapes and dtypes on the meta device: nothing is
    allocated (the reference's ``jax.eval_shape`` dry run)."""
    return init_train_state(cfg, _MetaGenerator(), grad_compression)


# ---------------------------------------------------------------------------
# dry-run cells
# ---------------------------------------------------------------------------
def _abstract_params(cfg: ModelConfig, rules: Optional[Rules]) -> nn.Module:
    """The params in ``cfg.dtype`` on meta (the copy the serve path holds),
    laid out on the mesh with ``rules``."""
    params = cast_params(build_model(cfg).init(_MetaGenerator()), cfg.dtype)
    if rules is not None:
        params = distribute_params(cfg, rules, params, "meta")
    return params


def shape_cells(cfg: ModelConfig, shape: ShapeConfig, mesh=None
                ) -> functools.partial:
    """Dispatch: train shapes the train step, decode shapes the serve step,
    prefill shapes the prefill step, each on meta tensors (nothing is
    allocated) laid out on ``mesh`` by ``SR.make_rules`` (None: one device,
    no rules). Returns the step bound to its arguments, a callable of none
    whose ``.args`` are those arguments (the reference's lowered step, its
    arguments the ``in_shardings``' placed specs): the train state from
    :func:`abstract_train_state`, the params in ``cfg.dtype`` for serve and
    prefill, the inputs from ``models/registry.py``'s specs placed by the
    batch's (and the cache's) shardings."""
    rules = SR.make_rules(cfg, shape, mesh) if mesh is not None else None
    if shape.kind == "train":
        state = abstract_train_state(cfg)
        if rules is not None:
            state = distribute_train_state(cfg, rules, state["params"],
                                           device="meta")
        batch = place_inputs(cfg, rules, train_input_specs(cfg, shape))
        return functools.partial(make_train_step(cfg, rules), state, batch,
                                 {"lr": 1e-3})
    params = _abstract_params(cfg, rules)
    if shape.kind == "decode":
        from repro_torch.models.transformer import place_cache
        specs = decode_input_specs(cfg, shape)
        with use_rules(rules):
            cache = place_cache(cfg, specs["cache"])
        tokens = place_inputs(cfg, rules, {"tokens": specs["tokens"]})
        return functools.partial(make_serve_step(cfg, rules), params,
                                 tokens["tokens"], cache)
    # prefill: the decode cache allocated at prefill length + headroom
    step = make_prefill_step(cfg, rules, shape.seq_len + 128)
    return functools.partial(step, params, place_inputs(
        cfg, rules, prefill_input_specs(cfg, shape)))
