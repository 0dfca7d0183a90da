"""RG-LRU recurrent block (RecurrentGemma / Griffin).

PyTorch counterpart of ``repro/models/rglru.py``. Per channel:
  r_t = sigmoid(W_a x_t + b_a); i_t = sigmoid(W_x x_t + b_x)
  a_t = exp(c * softplus(Lambda) * (-r_t))        (c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
and the block is y = W_out[ GeLU(W_gate x) * RGLRU(conv4(W_in x)) ].

Several steps (S > 1: the prefill, or steps from a state) run the
recurrence through :func:`repro_torch.kernels.ops.rglru_scan`: on a CUDA
tensor the hand-written scan kernel, on a CPU tensor its plain sequential
version; a state h0 is then carried in as ``cumprod(a) * h0``, as the
reference adds ``a_s * h0``. The reference computes the same function with
``jax.lax.associative_scan`` (it does not call its Pallas kernel). Decode
is the O(1) sequential update in plain torch, as in the reference, which
has no kernel there.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.ssm import _causal_conv
from repro_torch.sharding import shard

_C = 8.0


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


class BlockDiag(nn.Module):
    """Griffin's BlockDiagonalLinear: ``weight`` [nb,c,c] and ``bias``
    [nb,c], the reference's ``w`` and ``b`` as they are (not an
    ``nn.Linear``: each of the nb channel blocks has its own [c,c] map)."""

    def __init__(self, gen: torch.Generator, width: int, nb: int, dtype):
        super().__init__()
        c = width // nb
        self.weight = nn.Parameter(torch.empty(
            (nb, c, c), dtype=dtype,
            device=gen.device).normal_(generator=gen).mul_(c ** -0.5))
        self.bias = nn.Parameter(torch.zeros((nb, c), dtype=dtype,
                                             device=gen.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, width = x.shape
        nb, c, _ = self.weight.shape
        y = torch.einsum("bsnc,ncd->bsnd", x.reshape(b, s, nb, c),
                         self.weight) + self.bias
        return y.reshape(b, s, width)


class RGLRU(nn.Module):
    """The reference's ``rglru_init`` params: ``in`` (registered under that
    name, a Python keyword, so the state dict keeps the reference's keys),
    ``gate``, ``out``, ``conv_w`` [W,lw], ``conv_b``, ``wa``, ``wx`` and
    ``lam`` (fp32 whatever the params' dtype, as there, and a parameter, so
    that the decode copy casts it as the reference's ``_cast_tree`` does)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype):
        super().__init__()
        r = cfg.rglru
        lw, d, nb = _width(cfg), cfg.d_model, cfg.num_heads
        dev = gen.device
        self.add_module("in", L.dense_init(gen, d, lw, dtype))
        self.gate = L.dense_init(gen, d, lw, dtype)
        self.out = L.dense_init(gen, lw, d, dtype)
        self.conv_w = nn.Parameter(torch.empty(
            (r.conv_width, lw), dtype=dtype,
            device=dev).normal_(generator=gen).mul_(0.2))
        self.conv_b = nn.Parameter(torch.zeros(lw, dtype=dtype, device=dev))
        self.wa = BlockDiag(gen, lw, nb, dtype)
        self.wx = BlockDiag(gen, lw, nb, dtype)
        # Lambda so that a^c spans (0.9, 0.999) at r = 1 (Griffin appendix)
        base = torch.linspace(0.9, 0.999, lw, dtype=torch.float32, device=dev)
        self.lam = nn.Parameter(torch.log(torch.expm1(-torch.log(base) / _C)))

    @property
    def in_proj(self) -> nn.Linear:
        return getattr(self, "in")


def _rglru_core(p: RGLRU, x: torch.Tensor, h0: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,W] -> (y [B,S,W] in x's dtype, h_final [B,W] fp32)."""
    rgate = torch.sigmoid(p.wa(x).float())
    igate = torch.sigmoid(p.wx(x).float())
    log_a = -_C * F.softplus(p.lam) * rgate                   # [B,S,W] (<=0)
    a = torch.exp(log_a)
    gated = igate * x.float()
    # multiply by sqrt(1-a^2) (input normalization, stable form)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0))
    u = beta * gated

    if x.shape[1] == 1 and h0 is not None:                    # decode
        h = a[:, 0] * h0 + u[:, 0]
        return h[:, None].to(x.dtype), h
    h_s = kops.rglru_scan(a, u)
    if h0 is not None:
        h_s = h_s + torch.cumprod(a, dim=1) * h0[:, None]
    return h_s.to(x.dtype), h_s[:, -1]


def rglru_block(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Griffin recurrent block. x: [B,S,D]. Returns (y, {"conv": [B,W-1,lw],
    "lru": [B,lw] fp32})."""
    conv_state = None if state is None else state["conv"]
    h0 = None if state is None else state["lru"]
    branch = shard(p.in_proj(x), "batch", None, "model_ff")
    branch, new_conv = _causal_conv(branch, p.conv_w, p.conv_b, conv_state)
    rec, h_fin = _rglru_core(p, branch, h0)
    gate = F.gelu(p.gate(x), approximate="tanh")
    return p.out(gate * rec), {"conv": new_conv, "lru": h_fin}


def init_rglru_state(cfg: ModelConfig, batch: int, layers: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """Per-layer decode state: conv in ``dtype``, lru in fp32."""
    lw = _width(cfg)
    return {
        "conv": torch.zeros((layers, batch, cfg.rglru.conv_width - 1, lw),
                            dtype=dtype, device=device),
        "lru": torch.zeros((layers, batch, lw), dtype=torch.float32,
                           device=device),
    }
