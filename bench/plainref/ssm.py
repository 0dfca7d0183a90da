"""Plain fp32 reference of a Mamba2 (SSD) decoder: RMSNorm, the input
projection to (z, x, B, C, dt), a causal depthwise convolution with SiLU
over (x, B, C), the SSD recurrence

    h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t,

a gated RMSNorm of y * silu(z), the output projection, a tied embedding
table and the mean next-token cross-entropy.

The recurrence is computed in its chunked form (quadratic inside a chunk,
the state carried from chunk to chunk), written from the SSD paper
(arXiv:2405.21060, section 6) in plain PyTorch. Each layer is recomputed
in the backward. Parameters are keyed by the program's module names.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from plainref.common import Numerics, mean_xent, rmsnorm


def _dims(m: dict):
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    return s, d_in, d_in // s["head_dim"]


def param_spec(m: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter: init is ``normal:<std>``,
    ``zeros``, ``ones`` or ``a_log`` (log of 1..16 spread over the heads)."""
    s, d_in, nh = _dims(m)
    d, v, n = m["d_model"], m["vocab_size"], s["state_dim"]
    conv_ch = d_in + 2 * n
    spec = [("embed.weight", (v, d), "normal:0.02"),
            ("final_norm.scale", (d,), "ones")]
    if not m.get("tie_embeddings", False):
        spec.append(("head.weight", (v, d), "normal:0.02"))
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        spec += [
            (p + "ln1.scale", (d,), "ones"),
            (p + "mixer.in_proj.weight", (2 * d_in + 2 * n + nh, d),
             f"normal:{d ** -0.5!r}"),
            (p + "mixer.conv_w", (s["conv_width"], conv_ch), "normal:0.2"),
            (p + "mixer.conv_b", (conv_ch,), "zeros"),
            (p + "mixer.A_log", (nh,), "a_log"),
            (p + "mixer.D", (nh,), "ones"),
            (p + "mixer.dt_bias", (nh,), "zeros"),
            (p + "mixer.norm.scale", (d_in,), "ones"),
            (p + "mixer.out_proj.weight", (d, d_in),
             f"normal:{d_in ** -0.5!r}"),
        ]
    return spec


def ssd(num: Numerics, x, dt, a, bmat, cmat, chunk: int):
    """The SSD recurrence over x [B,S,H,P] with dt [B,S,H], a [H] (< 0),
    B/C [B,S,N] shared by the heads; y [B,S,H,P]."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    state = x.new_zeros((b, h, p, n))
    ys = []
    for c0 in range(0, s, chunk):
        c1 = min(s, c0 + chunk)
        xc, dtc = x[:, c0:c1], dt[:, c0:c1]
        bc, cc = bmat[:, c0:c1], cmat[:, c0:c1]
        cum = torch.cumsum(dtc * a, dim=1)                      # [B,Q,H]
        q = c1 - c0
        seg = cum[:, :, None, :] - cum[:, None, :, :]           # [B,t,s,H]
        causal = torch.ones(q, q, dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
        scores = num.scan_einsum("btn,bsn->bts", cc, bc)        # [B,t,s]
        w = decay * scores[..., None] * dtc[:, None, :, :]      # [B,t,s,H]
        y = num.scan_einsum("btsh,bshp->bthp", w, xc)
        y = y + torch.exp(cum)[..., None] * num.scan_einsum(
            "btn,bhpn->bthp", cc, state)
        to_end = torch.exp(cum[:, -1:, :] - cum) * dtc          # [B,Q,H]
        state = state * torch.exp(cum[:, -1])[:, :, None, None] \
            + num.scan_einsum("bshp,bsn->bhpn", xc * to_end[..., None], bc)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _conv(x, w, bias):
    """Causal depthwise convolution of x [B,S,C] with w [W,C], then SiLU."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(width)) + bias
    return F.silu(y)


def _layer(num: Numerics, m: dict, p: Dict[str, torch.Tensor], i: int, x):
    pre = f"layers.{i}.mixer."
    s, d_in, nh = _dims(m)
    n, hp = s["state_dim"], s["head_dim"]
    b, seq, _ = x.shape
    h = num.q(rmsnorm(x, p[f"layers.{i}.ln1.scale"]))
    z, xi, bm, cm, dt = torch.split(
        num.linear(h, p[pre + "in_proj.weight"]), [d_in, d_in, n, n, nh],
        dim=-1)
    dt = F.softplus(dt + p[pre + "dt_bias"])
    a = -torch.exp(p[pre + "A_log"])
    xi, bm, cm = torch.split(
        num.q(_conv(torch.cat([xi, bm, cm], -1), p[pre + "conv_w"],
                    p[pre + "conv_b"])), [d_in, n, n], dim=-1)
    xh = xi.reshape(b, seq, nh, hp)
    y = ssd(num, xh, dt, a, bm, cm, s["chunk"])
    y = num.q(y + p[pre + "D"][None, None, :, None] * xh)
    y = num.q(rmsnorm(y.reshape(b, seq, d_in) * F.silu(z),
                      p[pre + "norm.scale"]))
    return num.q(x + num.linear(y, p[pre + "out_proj.weight"]))


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
