"""Optimizer API: AdamW and Adafactor (factored, for the >100B archs), as
the reference's ``repro/optim/api.py``.

``init_opt(cfg, params)`` -> state ``{"step": int32 scalar, "inner": ...}``;
``apply_updates`` -> (params, state, stats). The optimizer kind comes from
the config. Unlike the reference, the update is in place: the params (the
port's module of per-layer tensors) and the moments are written where they
lie, and the returned state holds the new step.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import adamw_init, adamw_update

OptState = Dict[str, Any]   # {"step": int32[], "inner": ...}


def init_opt(cfg: ModelConfig, params: nn.Module) -> OptState:
    inner = adafactor_init(params) if cfg.optimizer == "adafactor" \
        else adamw_init(params)
    dev = next(params.parameters()).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "inner": inner}


def apply_updates(cfg: ModelConfig, params: nn.Module,
                  grads: Dict[str, torch.Tensor], state: OptState, lr,
                  gscale=1.0) -> Tuple[nn.Module, OptState, Dict[str, Any]]:
    """gscale folds gradient clipping / averaging into the update, so no
    scaled copy of the gradients is kept."""
    step = state["step"] + 1
    update = adafactor_update if cfg.optimizer == "adafactor" \
        else adamw_update
    params, inner, stats = update(params, grads, state["inner"], step, lr,
                                  gscale)
    return params, {"step": step, "inner": inner}, stats
