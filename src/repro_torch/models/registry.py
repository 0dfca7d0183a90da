"""Model registry: uniform build API per config.

``build_model(cfg)`` returns a ``Model`` bundle of functions, as the
reference's registry does; the executor invokes them per task. Every
family is ported: the decoder-only ones (dense, MoE, VLM, SSM, hybrid) in
``models/transformer.py``, enc-dec in ``models/encdec.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import FAMILY_ENCDEC, ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]
    prefill: Callable[[Any, Dict[str, Any], int], Tuple[torch.Tensor, Any]]
    decode_step: Callable[[Any, torch.Tensor, Any], Tuple[torch.Tensor, Any]]
    train_loss: Callable[[Any, Dict[str, Any]], Tuple[torch.Tensor, Any]]
    init_cache: Callable[[int, int, Any], Any]


def build_model(cfg: ModelConfig) -> Model:
    mod = ED if cfg.family == FAMILY_ENCDEC else T
    return Model(
        cfg=cfg,
        init=lambda gen: mod.init_params(cfg, gen),
        prefill=lambda p, b, m: mod.prefill(cfg, p, b, m),
        decode_step=lambda p, t, c: mod.decode_step(cfg, p, t, c),
        train_loss=lambda p, b: mod.train_loss(cfg, p, b),
        init_cache=lambda b, m, device: mod.init_cache(cfg, b, m, device),
    )
