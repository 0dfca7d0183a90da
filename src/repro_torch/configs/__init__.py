"""Config registry: ``get_config(arch_id)`` and reduced smoke configs."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (
    FAMILY_DENSE, FAMILY_ENCDEC, FAMILY_HYBRID, FAMILY_MOE, FAMILY_SSM,
    FAMILY_VLM, SUBQUADRATIC_FAMILIES, MULTI_POD, SHAPES, SINGLE_POD, H100_SXM,
    HardwareConfig, MeshConfig, ModelConfig, MoEConfig, RGLRUConfig,
    ShapeConfig, SSMConfig,
)

from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.glm4_9b import CONFIG as _glm4
from repro_torch.configs.command_r_plus_104b import CONFIG as _commandr
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _seamless, _mamba2, _rgemma, _starcoder2, _qwen2, _glm4, _commandr,
        _granite, _kimi, _qwen2vl,
    ]
}

ARCH_IDS: List[str] = list(ARCHS)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    return ARCHS[arch]


def cell_status(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """Whether an (arch x shape) cell runs or is a documented skip."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return "skip:full-attention"
    return "run"


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (small layers/width/
    experts/vocab) — structure preserved, scale shrunk."""
    cfg = get_config(arch)
    upd = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        dtype="float32",
        param_dtype="float32",
        remat=False,
        fsdp=False,
        microbatches=1,
        optimizer=cfg.optimizer,
    )
    if cfg.moe is not None:
        upd["moe"] = MoEConfig(num_experts=4, top_k=2, expert_ff=32,
                               dispatch=cfg.moe.dispatch)
        upd["d_ff"] = 32
    if cfg.ssm is not None:
        upd["ssm"] = SSMConfig(state_dim=16, head_dim=8, expand=2, chunk=16,
                               conv_width=4)
        upd["num_heads"] = 16   # d_inner(128)/head_dim(8)
        upd["num_kv_heads"] = 16
        upd["d_ff"] = 0
    if cfg.rglru is not None:
        upd["rglru"] = RGLRUConfig(lru_width=64, window=8,
                                   pattern=cfg.rglru.pattern, conv_width=4)
        upd["num_layers"] = 3   # one full rec/rec/attn pattern
        upd["num_kv_heads"] = 1
    if cfg.family == FAMILY_ENCDEC:
        upd["num_encoder_layers"] = 2
        upd["cross_kv_len"] = 16
    return dataclasses.replace(cfg, **upd)


__all__ = [
    "ARCHS", "ARCH_IDS", "SHAPES", "SINGLE_POD", "MULTI_POD", "H100_SXM",
    "get_config", "smoke_config", "cell_status",
    "ModelConfig", "ShapeConfig", "MeshConfig", "HardwareConfig",
    "MoEConfig", "SSMConfig", "RGLRUConfig",
    "FAMILY_DENSE", "FAMILY_MOE", "FAMILY_SSM", "FAMILY_HYBRID",
    "FAMILY_ENCDEC", "FAMILY_VLM",
]
