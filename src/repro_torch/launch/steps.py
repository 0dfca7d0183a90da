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
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.interop import reference_leaves
from repro_torch.models.registry import build_model
from repro_torch.optim import apply_updates, init_opt
from repro_torch.optim.clipping import global_norm
from repro_torch.optim.compression import compress_grads, init_error


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


def make_serve_step(cfg: ModelConfig, temperature: float = 0.0):
    """(params, tokens, cache, generator) -> (next_tokens, cache, logprobs).

    ``params`` in ``cfg.dtype`` (see :func:`cast_params`); greedy at
    temperature 0, else sampled with ``generator``."""
    model = build_model(cfg)

    @torch.no_grad()
    def step(params, tokens, cache, generator: Optional[torch.Generator] = None):
        logits, new_cache = model.decode_step(params, tokens, cache)
        logits = logits[:, -1].float()
        if temperature > 0:
            nxt = torch.multinomial(torch.softmax(logits / temperature, -1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        lp = torch.log_softmax(logits, dim=-1)
        sel = torch.gather(lp, -1, nxt[:, None])[:, 0]
        return nxt[:, None].to(torch.int32), new_cache, sel

    return step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """(params, batch) -> (first generated token [B,1], cache), with
    ``params`` in ``cfg.dtype`` (the reference casts inside the step)."""
    model = build_model(cfg)

    @torch.no_grad()
    def step(params, batch):
        logits, cache = model.prefill(params, batch, max_len)
        return torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32), cache

    return step


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
def loss_and_grads(cfg: ModelConfig, params: nn.Module,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """(loss, metrics, grads): ``train_loss`` on the master ``params`` cast
    to ``cfg.dtype`` and its gradients with respect to the masters, by
    parameter name. The backward runs inside the ``functional_call``, so
    that remat's recompute reads the casts too."""
    model = build_model(cfg)
    dt = getattr(torch, cfg.dtype)
    names, masters = zip(*params.named_parameters())

    def run(lm, b):
        loss, metrics = model.train_loss(lm, b)
        grads = torch.autograd.grad(loss, masters)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(names, grads))

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


def make_train_step(cfg: ModelConfig, grad_compression: bool = False):
    """(state, batch, knobs) -> (state, metrics).

    state = {"params": the master module, "opt", "err"?}; batch = the
    family's inputs (``data.pipeline.batch_for``: tokens or embeds and
    mrope_positions, or frames and tokens; labels) on the params' device;
    knobs = {"lr": float}."""

    def step(state, batch, knobs):
        params = state["params"]
        mb = max(1, cfg.microbatches)
        if mb == 1:
            loss, metrics, grads = loss_and_grads(cfg, params, batch)
        else:
            # gradient accumulation: one microbatch's activations at a time,
            # the sum kept in the first microbatch's gradients (in place:
            # no third set of gradients, 10.6 GB at recurrentgemma-9b's
            # 8-layer cut)
            grads, losses, mets = None, [], []
            for i in range(mb):
                l_, m_, g_ = loss_and_grads(cfg, params, _micro(batch, mb, i))
                if grads is None:
                    grads = g_
                else:
                    torch._foreach_add_(list(grads.values()),
                                        [g_[n] for n in grads])
                del g_
                losses.append(l_)
                mets.append(m_)
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
        return out, dict(metrics, loss=loss, grad_norm=gnorm, **stats)

    return step


def init_train_state(cfg: ModelConfig, gen: torch.Generator,
                     grad_compression: bool = False) -> Dict[str, Any]:
    """Master params from ``gen`` (on its device) and a fresh optimizer
    state; ``err`` (zeros) with ``grad_compression``."""
    params = build_model(cfg).init(gen).requires_grad_(True)
    state = {"params": params, "opt": init_opt(cfg, params)}
    if grad_compression:
        state["err"] = init_error(params)
    return state


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
