"""Mamba2 SSD (state-space duality) mixer.

PyTorch counterpart of ``repro/models/ssm.py``. Prefill runs the SSD scan
through :func:`repro_torch.kernels.ops.ssd_scan`: on a CUDA tensor the
hand-written chunked-scan kernel, on a CPU tensor its plain sequential
version. The reference computes the same function with ``ssd_chunked``
(its chunked dual form with an associative scan across chunks, which does
not call its Pallas kernel). A ragged tail needs no padding here: the
kernel masks it, which equals the reference's zero-dt padding.

Decode keeps an O(1) recurrent state per layer, ``{"conv": [B,W-1,Cin],
"ssm": [B,H,P,N]}``, and updates it sequentially in plain torch, as the
reference does (it has no kernel there).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.sharding import shard


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.state_dim     # x, B, C go through the conv
    return s, d_in, nheads, conv_ch


class SSDMixer(nn.Module):
    """The reference's ``ssd_init`` params. ``A_log``, ``D`` and ``dt_bias``
    are fp32 whatever the params' dtype, as there, and are parameters, so
    that a cast of the params (the decode copy) casts them too, as the
    reference's ``_cast_tree`` does."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype):
        super().__init__()
        s, d_in, nh, conv_ch = _dims(cfg)
        dev = gen.device
        self.in_proj = L.dense_init(gen, cfg.d_model,
                                    2 * d_in + 2 * s.state_dim + nh, dtype)
        self.conv_w = nn.Parameter(torch.empty(
            (s.conv_width, conv_ch), dtype=dtype,
            device=dev).normal_(generator=gen).mul_(0.2))
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, dtype=dtype,
                                               device=dev))
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, nh, dtype=torch.float32, device=dev)))
        self.D = nn.Parameter(torch.ones(nh, dtype=torch.float32, device=dev))
        self.dt_bias = nn.Parameter(torch.zeros(nh, dtype=torch.float32,
                                                device=dev))
        self.norm = L.Norm(d_in, "rmsnorm", dtype, dev)
        self.out_proj = L.dense_init(gen, d_in, cfg.d_model, dtype)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s, d_in, nh, _ = _dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, s.state_dim, s.state_dim, nh],
                       dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x: [B,S,C]; w: [W,C]. Returns (y, new_state).

    The state and x are joined in their promoted dtype, as
    ``jnp.concatenate`` does: decode after an fp32 prefill keeps an fp32
    conv state next to bf16 inputs."""
    wlen = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], wlen - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)
    y = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(wlen)) + b
    return F.silu(y), xp[:, -(wlen - 1):]


def ssd_mixer(p: SSDMixer, x: torch.Tensor, cfg: ModelConfig,
              state: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full Mamba2 block mixer. x: [B,S,D].

    state=None: prefill (the SSD scan over the whole prompt), returns the
    final state dict. state given: S must be 1 (decode); sequential update.
    """
    s, d_in, nh, _ = _dims(cfg)
    z, xi, bmat, cmat, dt = _split_proj(cfg, p.in_proj(x))
    dt = F.softplus(dt.float() + p.dt_bias)                      # [B,S,H]
    a = -torch.exp(p.A_log)                                      # [H]

    conv_in = torch.cat([xi, bmat, cmat], dim=-1)
    conv_state = None if state is None else state["conv"]
    conv_out, new_conv = _causal_conv(conv_in, p.conv_w, p.conv_b,
                                      conv_state)
    xi, bmat, cmat = torch.split(conv_out, [d_in, s.state_dim, s.state_dim],
                                 dim=-1)
    bsz, seq = x.shape[:2]
    xh = shard(xi.reshape(bsz, seq, nh, s.head_dim), "batch", None,
               "model_heads")

    if state is None:
        # [B,S,H,P] -> [B*H,S,P]; B and C stay [B,S,N], shared by the H heads
        xs = xh.float().permute(0, 2, 1, 3).reshape(bsz * nh, seq,
                                                    s.head_dim)
        dts = dt.permute(0, 2, 1).reshape(bsz * nh, seq)
        das = dts * a.repeat(bsz)[:, None]
        y, fin = kops.ssd_scan(xs, bmat.float(), cmat.float(), dts, das,
                               chunk=s.chunk, heads_per_bc=nh)
        y = y.reshape(bsz, nh, seq, s.head_dim).permute(0, 2, 1, 3)
        new_state = {"conv": new_conv,
                     "ssm": fin.reshape(bsz, nh, s.head_dim, s.state_dim)}
    else:
        # decode: h' = exp(dt*a)*h + dt*B (x) ; y = C.h
        h0 = state["ssm"]                                        # [B,H,P,N]
        dt1 = dt[:, 0]                                           # [B,H]
        decay = torch.exp(dt1 * a[None, :])                      # [B,H]
        inc = (dt1[..., None] * xh[:, 0].float())[..., None] \
            * bmat[:, 0].float()[:, None, None, :]               # [B,H,P,N]
        h1 = h0 * decay[..., None, None] + inc
        y = (h1 * cmat[:, 0].float()[:, None, None, :]).sum(-1)
        y = y[:, None]                                           # [B,1,H,P]
        new_state = {"conv": new_conv, "ssm": h1}

    y = y + p.D[None, None, :, None] * xh.float()
    y = y.reshape(bsz, seq, d_in).to(x.dtype)
    y = p.norm(y * F.silu(z))                                    # gated norm
    return p.out_proj(y), new_state


def init_ssm_state(cfg: ModelConfig, batch: int, layers: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    """Per-layer decode state: conv in ``dtype``, ssm in fp32."""
    s, d_in, nh, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((layers, batch, s.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((layers, batch, nh, s.head_dim, s.state_dim),
                           dtype=torch.float32, device=device),
    }
