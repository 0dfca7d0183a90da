"""Serve step builders (the decode and prefill halves of the reference's
``launch/steps.py``; the train half comes with the training slice).

The reference casts the fp32 master params to ``cfg.dtype`` inside every
serve step. Here the caller holds one copy of the params in ``cfg.dtype``
(:func:`cast_params`, made once) and passes it to the step, which computes
the same thing without a cast per token.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import build_model


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
