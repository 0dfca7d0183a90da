"""Decoder-only LM for the dense family: init, prefill with KV-cache build,
and one decode step.

PyTorch counterpart of the dense paths of ``repro/models/transformer.py``.
The reference stacks per-layer leaves on a leading [L] axis and runs
``lax.scan`` over them; here the layers are an ``nn.ModuleList`` and the
scan is a loop. The KV cache keeps the reference's layout
(``[L,B,Smax,Hkv,Dh]`` plus an int32 scalar ``idx``, both on the model's
device), and decode writes it in place. The MoE, SSM, hybrid, VLM and
enc-dec families come with later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import FAMILY_DENSE, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class AttnBlock(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype):
        super().__init__()
        self.ln1 = L.Norm(cfg.d_model, cfg.norm, dtype, gen.device)
        self.attn = A.Attention(gen, cfg, dtype)
        if cfg.d_ff:
            self.ln2 = L.Norm(cfg.d_model, cfg.norm, dtype, gen.device)
            self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, cfg.glu, cfg.act,
                             dtype)


class DecoderLM(nn.Module):
    """Parameters of the dense decoder (the reference's param pytree)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        dtype = getattr(torch, cfg.param_dtype)  # master params
        self.embed = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
        self.final_norm = L.Norm(cfg.d_model, cfg.norm, dtype, gen.device)
        if not cfg.tie_embeddings:
            self.head = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
        self.layers = nn.ModuleList(
            AttnBlock(gen, cfg, dtype) for _ in range(cfg.num_layers))


def init_params(cfg: ModelConfig, gen: torch.Generator) -> DecoderLM:
    """Seeded init on ``gen.device``, in ``cfg.param_dtype``."""
    if cfg.family != FAMILY_DENSE:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return DecoderLM(gen, cfg)


# ---------------------------------------------------------------------------
# blocks (prefill: cache=None; decode: cache per layer)
# ---------------------------------------------------------------------------
def _attn_block(p: AttnBlock, x, cfg: ModelConfig, *, positions, window=0,
                cache=None, idx=None):
    h = p.ln1(x)
    out, new_kv = A.attention(p.attn, h, cfg, positions=positions,
                              causal=True, window=window, cache_kv=cache,
                              cache_idx=idx)
    x = x + out
    if cfg.d_ff:
        h = p.ln2(x)
        x = x + p.mlp(h)
    return x, new_kv


def _run_stack(cfg: ModelConfig, params: DecoderLM, x, *, positions,
               caches=None, idx=None):
    """Returns (x, caches). With caches, each layer's K/V slice
    ``caches[...][i]`` is updated in place."""
    for i, lp in enumerate(params.layers):
        cache = None if caches is None else (caches["k"][i], caches["v"][i])
        x, _ = _attn_block(lp, x, cfg, positions=positions, cache=cache,
                           idx=idx)
    return x, caches


def _head_table(cfg: ModelConfig, params: DecoderLM) -> nn.Embedding:
    return params.embed if cfg.tie_embeddings else params.head


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Dict[str, Any]:
    cache = A.init_kv_cache(cfg, batch, max_len, _dtype(cfg), cfg.num_layers,
                            device)
    return {"layers": {"k": cache["k"], "v": cache["v"]},
            "idx": cache["idx"]}


def prefill(cfg: ModelConfig, params: DecoderLM, batch: Dict[str, Any],
            max_len: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt, build the decode cache, return last-position logits.

    Runs in the params' dtype (the serve path prefills with the fp32 master
    params, as the reference does); the cache is ``cfg.dtype``."""
    x = params.embed(batch["tokens"])
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, max_len, x.device)
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params.layers):
        x, (k, v) = _attn_block(lp, x, cfg, positions=positions)
        ck[i, :, :s] = k.to(ck.dtype)
        cv[i, :, :s] = v.to(cv.dtype)
    cache["idx"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    x = params.final_norm(x)
    logits = L.unembed(_head_table(cfg, params), x[:, -1:])
    return logits, cache


def decode_step(cfg: ModelConfig, params: DecoderLM, tokens: torch.Tensor,
                cache: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. tokens: [B,1]. The cache's K/V are written in place;
    the returned cache holds them with ``idx + 1``."""
    x = params.embed(tokens)
    idx = cache["idx"]
    positions = idx[None, None] * torch.ones((x.shape[0], 1),
                                             dtype=torch.int32,
                                             device=x.device)
    x, new_caches = _run_stack(cfg, params, x, positions=positions,
                               caches=cache["layers"], idx=idx)
    x = params.final_norm(x)
    logits = L.unembed(_head_table(cfg, params), x[:, -1:])
    return logits, {"layers": new_caches, "idx": idx + 1}
