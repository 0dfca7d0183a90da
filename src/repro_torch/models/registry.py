"""Model registry: uniform build API per config.

``build_model(cfg)`` returns a ``Model`` bundle of functions, as the
reference's registry does; the executor invokes them per task. The dense,
SSM and hybrid families are ported for serving and training; the others
raise, naming the ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import (FAMILY_ENCDEC, FAMILY_MOE,
                                      FAMILY_VLM, ModelConfig)
from repro_torch.models import transformer as T

_WAITING = {
    FAMILY_MOE: "ROADMAP Queue 1, the MoE / VLM / enc-dec families",
    FAMILY_VLM: "ROADMAP Queue 1, the MoE / VLM / enc-dec families",
    FAMILY_ENCDEC: "ROADMAP Queue 1, the MoE / VLM / enc-dec families",
}


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]
    prefill: Callable[[Any, Dict[str, Any], int], Tuple[torch.Tensor, Any]]
    decode_step: Callable[[Any, torch.Tensor, Any], Tuple[torch.Tensor, Any]]
    train_loss: Callable[[Any, Dict[str, Any]], Tuple[torch.Tensor, Any]]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in T.PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_WAITING.get(cfg.family, 'not planned')}")
    return Model(
        cfg=cfg,
        init=lambda gen: T.init_params(cfg, gen),
        prefill=lambda p, b, m: T.prefill(cfg, p, b, m),
        decode_step=lambda p, t, c: T.decode_step(cfg, p, t, c),
        train_loss=lambda p, b: T.train_loss(cfg, p, b),
    )
