"""Plain fp32 reference of a dense decoder (qwen2): RMSNorm, GQA attention
with q/k/v biases and half-split RoPE, a SwiGLU MLP, a tied embedding
table and the mean next-token cross-entropy.

Written from the published architecture, in plain PyTorch: attention is
computed a block of queries at a time against the keys up to the block's
end, and each layer is recomputed in the backward, so that a long row
fits. Parameters are a flat dict keyed by the names :func:`param_spec`
lists (the program's module names).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from plainref.common import Numerics, mean_xent, rmsnorm

Q_BLOCK = 512


def param_spec(m: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter: init is ``normal:<std>``,
    ``zeros`` or ``ones``."""
    d, hd = m["d_model"], m["head_dim"]
    hq, hkv, ff, v = m["num_heads"], m["num_kv_heads"], m["d_ff"], \
        m["vocab_size"]
    spec = [("embed.weight", (v, d), "normal:0.02"),
            ("final_norm.scale", (d,), "ones")]
    if not m.get("tie_embeddings", False):
        spec.append(("head.weight", (v, d), "normal:0.02"))

    def dense(name, i, o, bias):
        out = [(f"{name}.weight", (o, i), f"normal:{i ** -0.5!r}")]
        return out + ([(f"{name}.bias", (o,), "zeros")] if bias else [])

    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        spec.append((p + "ln1.scale", (d,), "ones"))
        spec += dense(p + "attn.q", d, hq * hd, m["qkv_bias"])
        spec += dense(p + "attn.k", d, hkv * hd, m["qkv_bias"])
        spec += dense(p + "attn.v", d, hkv * hd, m["qkv_bias"])
        spec += dense(p + "attn.o", hq * hd, d, False)
        spec.append((p + "ln2.scale", (d,), "ones"))
        spec += dense(p + "mlp.up", d, ff, False)
        spec += dense(p + "mlp.down", ff, d, False)
        spec += dense(p + "mlp.gate", d, ff, False)
    return spec


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x [B,S,H,Dh] at positions 0..S-1."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                       device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    a, b = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(num: Numerics, q, k, v):
    """Causal GQA attention, q [B,S,Hq,Dh] over k/v [B,S,Hkv,Dh], a block
    of ``Q_BLOCK`` queries at a time."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, dh)
    outs = []
    for i0 in range(0, s, Q_BLOCK):
        i1 = min(s, i0 + Q_BLOCK)
        sc = num.einsum("bqhgd,bkhd->bhgqk", qg[:, i0:i1], k[:, :i1]) \
            * dh ** -0.5
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(i1, device=q.device)[None, :]
        sc = sc.masked_fill(kj > qi, float("-inf"))
        w = torch.softmax(sc, dim=-1)
        outs.append(num.einsum("bhgqk,bkhd->bqhgd", w, v[:, :i1]))
    return torch.cat(outs, dim=1).reshape(b, s, hq * dh)


def _layer(num: Numerics, m: dict, p: Dict[str, torch.Tensor], i: int, x):
    pre = f"layers.{i}."
    hq, hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    b, s, _ = x.shape
    h = num.q(rmsnorm(x, p[pre + "ln1.scale"]))

    def proj(name, heads):
        y = num.linear(h, p[pre + f"attn.{name}.weight"],
                       p.get(pre + f"attn.{name}.bias"))
        return y.reshape(b, s, heads, hd)

    q = _rope(proj("q", hq), m["rope_theta"])
    k = _rope(proj("k", hkv), m["rope_theta"])
    v = proj("v", hkv)
    x = num.q(x + num.linear(_attention(num, q, k, v),
                             p[pre + "attn.o.weight"]))
    h = num.q(rmsnorm(x, p[pre + "ln2.scale"]))
    g = num.q(F.silu(num.linear(h, p[pre + "mlp.gate.weight"])))
    u = num.linear(h, p[pre + "mlp.up.weight"])
    return num.q(x + num.linear(g * u, p[pre + "mlp.down.weight"]))


def loss(num: Numerics, m: dict, p: Dict[str, torch.Tensor],
         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token loss of ``batch`` (tokens, labels [B,S])."""
    x = num.q(p["embed.weight"][batch["tokens"].long()])
    for i in range(m["num_layers"]):
        x = checkpoint(_layer, num, m, p, i, x, use_reentrant=False)
    x = num.q(rmsnorm(x, p["final_norm.scale"]))
    table = p["embed.weight"] if m.get("tie_embeddings", False) \
        else p["head.weight"]
    return mean_xent(num, x, table, batch["labels"], m.get("loss_chunk", 256))
