"""Model registry: uniform build API per config, and the dry run's input
specs per (arch, shape).

``build_model(cfg)`` returns a ``Model`` bundle of functions, as the
reference's registry does; the executor invokes them per task. Every
family is ported: the decoder-only ones (dense, MoE, VLM, SSM, hybrid) in
``models/transformer.py``, enc-dec in ``models/encdec.py``.

The input specs are tensors on the ``meta`` device (shape and dtype, no
storage) where the reference returns ``jax.ShapeDtypeStruct``; the decode
cache is :func:`init_cache` on meta, which for enc-dec also holds the
decode kernel's ``cross_kv_len`` (one int32), a leaf the reference's cache
has not.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import FAMILY_ENCDEC, ModelConfig, ShapeConfig
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


# ---------------------------------------------------------------------------
# dry-run input specs (meta tensors, no allocation)
# ---------------------------------------------------------------------------
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)
    if cfg.family == FAMILY_ENCDEC:
        # enc frames seq = s; decoder tokens = s // 8 (speech:text ratio)
        dec = max(cfg.loss_chunk, s // 8)
        return {"frames": _spec((b, s, cfg.d_model), dt),
                "tokens": _spec((b, dec), i32),
                "labels": _spec((b, dec), i32)}
    batch: Dict[str, Any] = {"labels": _spec((b, s), i32)}
    if cfg.embed_stub:
        batch["embeds"] = _spec((b, s, cfg.d_model), dt)
    else:
        batch["tokens"] = _spec((b, s), i32)
    if cfg.mrope:
        batch["mrope_positions"] = _spec((3, b, s), i32)
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Specs for serve_step: one new token given a cache of seq_len."""
    b = shape.global_batch
    return {"tokens": _spec((b, 1), torch.int32),
            "cache": build_model(cfg).init_cache(b, shape.seq_len, "meta")}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if cfg.family == FAMILY_ENCDEC:
        return {"frames": _spec((b, s, cfg.d_model), dt),
                "tokens": _spec((b, max(64, s // 8)), torch.int32)}
    batch: Dict[str, Any] = {}
    if cfg.embed_stub:
        batch["embeds"] = _spec((b, s, cfg.d_model), dt)
    else:
        batch["tokens"] = _spec((b, s), torch.int32)
    if cfg.mrope:
        batch["mrope_positions"] = _spec((3, b, s), torch.int32)
    return batch
