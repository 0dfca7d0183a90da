"""Encoder-decoder backbone (SeamlessM4T-v2 style) with the audio-frame stub.

PyTorch counterpart of ``repro/models/encdec.py``. Encoder: a bidirectional
transformer over precomputed frame embeddings (the modality frontend is a
stub). Decoder: causal self-attention, cross-attention over the encoder's
output, FFN. The layers are ``nn.ModuleList``s (the reference stacks them
on a leading axis: ``encoder/...``, ``decoder/...``).

The decode cache keeps the self-attention K/V ``[L,B,Smax,Hkv,Dh]`` and the
encoder's output, cut or zero-padded to ``cfg.cross_kv_len`` frames, in
``cfg.dtype``; each decode step recomputes the cross K/V from it, and
attends all ``cross_kv_len`` frames, the padded ones included, as the
reference does. The prefill's cross-attention reads the whole encoder
output. On the card, attention runs in the flash kernel (the encoder,
not causal; the decoder's self-attention; the cross-attention at prefill
and in training, its queries fewer than its keys) and in the decode kernel
(the decode step's self- and cross-attention).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import chunked_xent
from repro_torch.sharding import shard


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class EncLayer(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype):
        super().__init__()
        dev = gen.device
        self.ln1 = L.Norm(cfg.d_model, cfg.norm, dtype, dev)
        self.attn = A.Attention(gen, cfg, dtype)
        self.ln2 = L.Norm(cfg.d_model, cfg.norm, dtype, dev)
        self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, cfg.glu, cfg.act, dtype)


class DecLayer(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype):
        super().__init__()
        dev = gen.device
        self.ln1 = L.Norm(cfg.d_model, cfg.norm, dtype, dev)
        self.self_attn = A.Attention(gen, cfg, dtype)
        self.ln_x = L.Norm(cfg.d_model, cfg.norm, dtype, dev)
        self.cross_attn = A.Attention(gen, cfg, dtype)
        self.ln2 = L.Norm(cfg.d_model, cfg.norm, dtype, dev)
        self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, cfg.glu, cfg.act, dtype)


class EncDecLM(nn.Module):
    """Parameters of the encoder-decoder (the reference's param pytree)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        dtype = getattr(torch, cfg.param_dtype)  # master params
        dev = gen.device
        self.embed = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
        self.head = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
        self.encoder = nn.ModuleList(EncLayer(gen, cfg, dtype)
                                     for _ in range(cfg.num_encoder_layers))
        self.decoder = nn.ModuleList(DecLayer(gen, cfg, dtype)
                                     for _ in range(cfg.num_layers))
        self.enc_norm = L.Norm(cfg.d_model, cfg.norm, dtype, dev)
        self.final_norm = L.Norm(cfg.d_model, cfg.norm, dtype, dev)

    def forward(self, fn, *args):
        """``fn(self, *args)``, as ``DecoderLM.forward``: lets
        ``torch.func.functional_call`` run this module's functions with its
        parameters replaced."""
        return fn(self, *args)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> EncDecLM:
    """Seeded init on ``gen.device``, in ``cfg.param_dtype``."""
    return EncDecLM(gen, cfg)


def _maybe_ckpt(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
    (the reference's ``jax.checkpoint`` of its scan body)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _enc_layer(cfg: ModelConfig, positions, lp: EncLayer, h):
    out, _ = A.attention(lp.attn, lp.ln1(h), cfg, positions=positions,
                         causal=False)
    h = h + out
    return h + lp.mlp(lp.ln2(h))


def encode(cfg: ModelConfig, params: EncDecLM,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: [B,Senc,D] precomputed embeddings (stub frontend), rounded to
    ``cfg.dtype`` as the reference casts them (the layers widen them where
    the params are wider: ``L.dense``)."""
    x = shard(frames.to(_dtype(cfg)), "batch", "seq", None)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in params.encoder:
        x = _maybe_ckpt(cfg, functools.partial(_enc_layer, cfg, positions,
                                               lp), x)
    return params.enc_norm(x)


def _dec_layer(cfg: ModelConfig, positions, idx, cross_len, lp: DecLayer, h,
               enc_out, ck=None, cv=None):
    """One decoder layer; with a cache (``ck``, ``cv``: this layer's
    [B,Smax,Hkv,Dh], written in place) at position ``idx``, its
    cross-attention over ``cross_len`` frames (the cache's
    ``cross_kv_len``). Returns (h, the fresh self K, V)."""
    cache = None if ck is None else (ck, cv)
    out, new_kv = A.attention(lp.self_attn, lp.ln1(h), cfg,
                              positions=positions, causal=True,
                              cache_kv=cache, cache_idx=idx)
    h = h + out
    enc_kv = A.encode_cross_kv(lp.cross_attn, enc_out, cfg)
    h = h + A.cross_attention(lp.cross_attn, lp.ln_x(h), enc_kv, cfg,
                              kv_len=cross_len)
    h = h + lp.mlp(lp.ln2(h))
    return h, new_kv[0], new_kv[1]


def _decoder_stack(cfg: ModelConfig, params: EncDecLM, x, enc_out,
                   positions, caches=None, idx=None, cross_len=None):
    """Returns (x, [(k, v)] per layer): the fresh K/V without a cache, the
    cache's own tensors (written in place) with one."""
    kvs = []
    for i, lp in enumerate(params.decoder):
        fn = functools.partial(_dec_layer, cfg, positions, idx, cross_len,
                               lp)
        if caches is None:
            x, k, v = _maybe_ckpt(cfg, fn, x, enc_out)
        else:
            x, k, v = fn(x, enc_out, caches["k"][i], caches["v"][i])
        kvs.append((k, v))
    return x, kvs


def train_loss(cfg: ModelConfig, params: EncDecLM, batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(mean next-token loss of the decoder, {"loss", "aux_loss": 0}) of
    ``batch`` (frames [B,Senc,D], tokens and labels [B,S])."""
    enc_out = encode(cfg, params, batch["frames"])
    x = shard(params.embed(batch["tokens"]), "batch", "seq", None)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = _decoder_stack(cfg, params, x, enc_out, positions)
    x = params.final_norm(x)
    loss = chunked_xent(cfg, x, params.head.weight, batch["labels"])
    return loss, {"loss": loss,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=x.device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Dict[str, Any]:
    dtype = _dtype(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"layers": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)},
            "enc_out": torch.zeros((batch, cfg.cross_kv_len, cfg.d_model),
                                   dtype=dtype, device=device),
            # the decode kernel's kv_len over enc_out, made once
            "cross_kv_len": torch.full((1,), cfg.cross_kv_len,
                                       dtype=torch.int32, device=device),
            "idx": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(cfg: ModelConfig, params: EncDecLM, batch: Dict[str, Any],
            max_len: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Encode the frames; prefill the decoder with the prompt tokens. The
    cache keeps the first ``cross_kv_len`` encoder frames (zero-padded to
    that many) for the decode steps' cross-attention."""
    enc_out = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params.embed(tokens)
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, max_len, x.device)
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    x, kvs = _decoder_stack(cfg, params, x, enc_out, positions)
    for i, (k, v) in enumerate(kvs):
        A.cache_write(ck[i], positions[0], k)
        A.cache_write(cv[i], positions[0], v)
    keep = enc_out[:, : cfg.cross_kv_len]
    cache["enc_out"][:, : keep.shape[1]] = keep.to(cache["enc_out"].dtype)
    cache["idx"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    x = params.final_norm(x)
    return L.unembed(params.head, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: EncDecLM, tokens: torch.Tensor,
                cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. tokens: [B,1]. The self-attention K/V are written
    into the cache in place; the returned cache holds them, the same
    encoder output and frame count, and ``idx + 1``."""
    x = params.embed(tokens)
    idx = cache["idx"]
    positions = idx[None, None] * torch.ones((x.shape[0], 1),
                                             dtype=torch.int32,
                                             device=x.device)
    x, _ = _decoder_stack(cfg, params, x, cache["enc_out"], positions,
                          caches=cache["layers"], idx=idx,
                          cross_len=cache["cross_kv_len"])
    x = params.final_norm(x)
    logits = L.unembed(params.head, x[:, -1:])
    return logits, {**cache, "idx": idx + 1}
