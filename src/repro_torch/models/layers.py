"""Shared neural layers: dense, norms, gated MLP, embeddings, RoPE.

PyTorch counterparts of ``repro/models/layers.py``. Parameters live in
``nn.Module``s created on the device of the ``torch.Generator`` that
initialises them (same distributions as the reference: dense weights
N(0, 1/in), zero biases, unit norm scales, embeddings N(0, 0.02^2)).
``nn.Linear`` keeps its weight as ``[out, in]``; the reference's ``w`` is
``[in, out]`` (``interop`` transposes). M-RoPE comes with the VLM slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               bias: bool = False, scale: Optional[float] = None) -> nn.Linear:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    lin = nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=bias,
                             device=gen.device, dtype=dtype)
    with torch.no_grad():
        lin.weight.normal_(generator=gen).mul_(scale)
        if bias:
            lin.bias.zero_()
    return lin


class Norm(nn.Module):
    """RMSNorm or LayerNorm: fp32 inside, cast back to the input's dtype."""

    def __init__(self, dim: int, kind: str, dtype, device, eps: float = 1e-6):
        super().__init__()
        self.kind, self.eps = kind, eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device)) \
            if kind == "layernorm" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.kind == "rmsnorm":
            y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        else:
            mu = xf.mean(-1, keepdim=True)
            var = (xf - mu).square().mean(-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + self.eps)
        y = y * self.scale.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# MLP (gated or plain)
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, d_ff: int,
                 glu: bool, act: str, dtype):
        super().__init__()
        self.act, self.glu = act, glu
        self.up = dense_init(gen, d_model, d_ff, dtype)
        self.down = dense_init(gen, d_ff, d_model, dtype)
        self.gate = dense_init(gen, d_model, d_ff, dtype) if glu else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.up(x)
        if self.glu:
            h = act_fn(self.act)(self.gate(x)) * h
        else:
            h = act_fn(self.act)(h)
        return self.down(h)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------
def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype) -> nn.Embedding:
    emb = nn.utils.skip_init(nn.Embedding, vocab, d_model, device=gen.device,
                             dtype=dtype)
    with torch.no_grad():
        emb.weight.normal_(generator=gen).mul_(0.02)
    return emb


def unembed(p: nn.Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits; used with tied or untied head table."""
    return x @ p.weight.T


# ---------------------------------------------------------------------------
# RoPE (half-split)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                    # [Dh/2]
    angles = positions[..., None].float() * freqs             # [..., S, Dh/2]
    angles = angles[..., None, :]                              # [..., S, 1, Dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1, xf2 = x[..., : dh // 2].float(), x[..., dh // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
