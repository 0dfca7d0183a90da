"""Plain fp32 reference of a Granite MoE decoder (granite-3.0 MoE):
RMSNorm, GQA attention with half-split RoPE and its own softmax scale, a
routed mixture of SwiGLU experts in place of the MLP, a tied embedding
table, and Granite's four multipliers.

Written from the published architecture (``config.json`` of
ibm-granite/granite-3.0-3b-a800m-base and the GraniteMoe model it
names), in plain PyTorch:

- the embeddings times ``embedding_multiplier``;
- attention logits times ``attention_multiplier`` (not 1/sqrt(head_dim));
- each block's branch added as ``x + residual_multiplier * f(x)``;
- the router: fp32 logits and softmax over the experts, each token's
  ``top_k`` likeliest experts with their probabilities renormalised to sum
  to 1; every token goes to each of its experts (no capacity, nothing
  dropped); each expert runs on its own tokens, one expert at a time,
  ``down(silu(gate(x)) * up(x))`` with gate and up the two halves of its
  ``input_linear`` (gate first);
- the load-balancing loss ``E * sum_e mean_prob_e * routed_frac_e`` summed
  over the layers, times ``aux_loss_weight`` (``router_aux_loss_coef``),
  added to the mean next-token cross-entropy;
- the logits divided by ``logits_scaling``.

Attention is computed a block of queries at a time, and each layer is
recomputed in the backward, as ``plainref/dense.py`` does. Parameters are a
flat dict keyed by the names :func:`param_spec` lists (the program's
module names).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from plainref.common import Numerics, rmsnorm
from plainref.dense import Q_BLOCK, _rope


def param_spec(m: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter: init is ``normal:<std>``,
    ``zeros`` or ``ones``."""
    d, hd = m["d_model"], m["head_dim"]
    hq, hkv, v = m["num_heads"], m["num_kv_heads"], m["vocab_size"]
    e, f = m["moe"]["num_experts"], m["moe"]["expert_ff"]
    spec = [("embed.weight", (v, d), "normal:0.02"),
            ("final_norm.scale", (d,), "ones")]
    if not m.get("tie_embeddings", False):
        spec.append(("head.weight", (v, d), "normal:0.02"))

    def dense(name, i, o):
        return [(f"{name}.weight", (o, i), f"normal:{i ** -0.5!r}")]

    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        spec.append((p + "ln1.scale", (d,), "ones"))
        spec += dense(p + "attn.q", d, hq * hd)
        spec += dense(p + "attn.k", d, hkv * hd)
        spec += dense(p + "attn.v", d, hkv * hd)
        spec += dense(p + "attn.o", hq * hd, d)
        spec.append((p + "ln2.scale", (d,), "ones"))
        spec.append((p + "moe.router", (d, e), f"normal:{d ** -0.5!r}"))
        spec.append((p + "moe.gate_up", (e, d, 2 * f),
                     f"normal:{d ** -0.5!r}"))
        spec.append((p + "moe.down", (e, f, d), f"normal:{f ** -0.5!r}"))
    return spec


def _attention(num: Numerics, q, k, v, scale: float):
    """Causal GQA attention, q [B,S,Hq,Dh] over k/v [B,S,Hkv,Dh], its logits
    times ``scale``, a block of ``Q_BLOCK`` queries at a time."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, dh)
    outs = []
    for i0 in range(0, s, Q_BLOCK):
        i1 = min(s, i0 + Q_BLOCK)
        sc = num.einsum("bqhgd,bkhd->bhgqk", qg[:, i0:i1], k[:, :i1]) * scale
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(i1, device=q.device)[None, :]
        sc = sc.masked_fill(kj > qi, float("-inf"))
        outs.append(num.einsum("bhgqk,bkhd->bqhgd", torch.softmax(sc, -1),
                               v[:, :i1]))
    return torch.cat(outs, dim=1).reshape(b, s, hq * dh)


def route(num: Numerics, m: dict, h: torch.Tensor, router: torch.Tensor):
    """(weights [T,k], expert ids [T,k], the layer's load-balancing loss)
    of tokens h [T,D]: fp32 logits of the (control-rounded) operands."""
    mo = m["moe"]
    probs = torch.softmax(num.q(h) @ num.q(router), dim=-1)      # [T,E]
    w, idx = torch.topk(probs, mo["top_k"], dim=-1)
    w = w / w.sum(-1, keepdim=True)
    routed = torch.zeros(mo["num_experts"], dtype=probs.dtype,
                         device=h.device)
    routed.index_add_(0, idx.reshape(-1),
                      torch.ones(idx.numel(), device=h.device))
    aux = mo["num_experts"] * torch.sum(probs.mean(0) * routed / h.shape[0])
    return w, idx, aux


def experts(num: Numerics, m: dict, p: Dict[str, torch.Tensor], pre: str,
            h: torch.Tensor, w: torch.Tensor, idx: torch.Tensor
            ) -> torch.Tensor:
    """Every token through each of its experts, weighed and summed: one
    expert at a time over the tokens routed to it."""
    f = m["moe"]["expert_ff"]
    out = torch.zeros_like(h)
    for e in range(m["moe"]["num_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = h[tok]
        gu = p[pre + "moe.gate_up"][e]                          # [D,2F]
        g = num.q(F.silu(num.einsum("td,df->tf", xe, gu[:, :f])))
        u = num.einsum("td,df->tf", xe, gu[:, f:])
        y = num.einsum("tf,fd->td", g * u, p[pre + "moe.down"][e])
        out = out.index_add(0, tok, y * w[tok, slot, None])
    return num.q(out)


def _layer(num: Numerics, m: dict, p: Dict[str, torch.Tensor], i: int, x,
           aux):
    pre = f"layers.{i}."
    hq, hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    r = m["residual_multiplier"]
    b, s, d = x.shape
    h = num.q(rmsnorm(x, p[pre + "ln1.scale"]))

    def proj(name, heads):
        return num.linear(h, p[pre + f"attn.{name}.weight"]).reshape(
            b, s, heads, hd)

    q = _rope(proj("q", hq), m["rope_theta"])
    k = _rope(proj("k", hkv), m["rope_theta"])
    att = _attention(num, q, k, proj("v", hkv), m["attention_multiplier"])
    x = num.q(x + r * num.linear(att, p[pre + "attn.o.weight"]))
    h = num.q(rmsnorm(x, p[pre + "ln2.scale"])).reshape(b * s, d)
    w, idx, a = route(num, m, h, p[pre + "moe.router"])
    y = experts(num, m, p, pre, h, w, idx).reshape(b, s, d)
    return num.q(x + r * y), aux + a


def _xent_block(num: Numerics, x, table, labels, logits_scaling: float):
    logits = num.linear(x, table) / logits_scaling
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(torch.logsumexp(logits, -1) - gold)


def loss(num: Numerics, m: dict, p: Dict[str, torch.Tensor],
         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token loss of ``batch`` (tokens, labels [B,S]) plus the
    load-balancing loss, ``chunk`` positions of logits at a time (each
    block recomputed in the backward)."""
    x = num.q(p["embed.weight"][batch["tokens"].long()]
              * m["embedding_multiplier"])
    aux = x.new_zeros(())
    for i in range(m["num_layers"]):
        x, aux = checkpoint(_layer, num, m, p, i, x, aux, use_reentrant=False)
    x = num.q(rmsnorm(x, p["final_norm.scale"]))
    table = p["embed.weight"] if m.get("tie_embeddings", False) \
        else p["head.weight"]
    labels, chunk = batch["labels"], m.get("loss_chunk", 256)
    b, s, _ = x.shape
    tot = x.new_zeros(())
    for c in range(0, s, chunk):
        tot = tot + checkpoint(_xent_block, num, x[:, c:c + chunk], table,
                               labels[:, c:c + chunk],
                               m["logits_scaling"], use_reentrant=False)
    return tot / (b * s) + m["moe"]["aux_loss_weight"] * aux
