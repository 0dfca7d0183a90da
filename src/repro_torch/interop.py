"""Carry parameters across from the reference package.

The reference keeps the decoder's params as a pytree of arrays whose
per-layer leaves are stacked on a leading axis; its checkpointer flattens
the tree to ``/``-joined keys (``embed/table``, ``final_norm/scale``;
dense: ``layers/ln1/scale``, ``layers/attn/q/w``, ``layers/attn/q/b``,
``layers/mlp/up/w``, ...; SSM: ``layers/mixer/in_proj/w``,
``layers/mixer/conv_w``, ``layers/mixer/A_log``, ...; hybrid:
``groups/pos0/mixer/in/w``, ``groups/pos0/mixer/wa/w``,
``groups/pos0/mixer/lam``, ``groups/pos2/attn/q/w``, ..., stacked over the
groups, and ``tail/mixer/...`` stacked over the tail layers; MoE:
``layers/moe/router`` ``[L, d, E]``, ``layers/moe/up`` ``[L, E_pad, d, f]``,
...; enc-dec: ``encoder/...`` and ``decoder/...`` stacked over their layers,
``head/table``, ``enc_norm/...``). :func:`params_from_jax` takes that tree,
nested or flat, as numpy arrays and returns a state dict of the port's
:class:`~repro_torch.models.transformer.DecoderLM` or
:class:`~repro_torch.models.encdec.EncDecLM`: the stacked axis of
``layers``, ``groups``, ``tail``, ``encoder`` and ``decoder`` is unstacked
(``layers.{i}``, ``groups.{g}.pos{i}``, ``tail.{j}``, ``encoder.{i}``,
``decoder.{i}``) and the dense ``[in, out]`` weights (the 2-D ``w`` leaves)
are transposed to ``nn.Linear``'s ``[out, in]``; every other leaf is copied
as it is: the block-diagonal gates' ``w`` ``[nb, c, c]``, the convs' ``[W,
C]`` ``conv_w``, ``lam``, the MoE router and expert slabs. Nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.layers import Norm


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> ``/``-joined keys (the checkpointer's key format for
    dict pytrees); leaves are returned as they are."""
    flat: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten(val, path))
        else:
            flat[path] = val
    return flat


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes, as JAX hands it out
        return torch.from_numpy(
            np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# leaves with a leading layer axis
_STACKED = ("layers", "groups", "tail", "encoder", "decoder")


def _leaf_name(parts) -> str:
    *mods, leaf = parts
    name = {"w": "weight", "b": "bias", "table": "weight"}.get(leaf, leaf)
    return ".".join([*mods, name])


def params_from_jax(tree_or_flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the dense, SSM or hybrid decoder from the reference's
    param tree."""
    flat = flatten(tree_or_flat)
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] in _STACKED:
            stacked = _tensor(arr)
            for i in range(stacked.shape[0]):
                t = stacked[i]
                if parts[-1] == "w" and t.dim() == 2:
                    t = t.T
                sd[f"{parts[0]}.{i}." + _leaf_name(parts[1:])] = \
                    t.contiguous()
        else:
            sd[_leaf_name(parts)] = _tensor(arr)
    return sd


def load_jax_params(model: nn.Module, tree_or_flat: Mapping[str, Any]
                    ) -> nn.Module:
    """Copy the reference's params into ``model`` (onto its device and
    dtype); every parameter must be matched."""
    with torch.no_grad():
        model.load_state_dict(params_from_jax(tree_or_flat), strict=True)
    return model


def jax_key(name: str, tensor: torch.Tensor,
            norm: bool = False) -> Tuple[str, bool]:
    """The reference's ``/``-joined key of the leaf that the port's
    parameter ``name`` is (one layer of, for a stacked leaf), and whether
    the port keeps it transposed (the 2-D ``w`` of a stacked leaf); the
    inverse of :func:`params_from_jax`'s naming. ``norm``: the parameter
    is a norm's (its ``bias`` keeps its name; a dense layer's is ``b``)."""
    parts = name.split(".")
    bias = "bias" if norm else "b"
    if parts[0] in _STACKED:
        rest = parts[2:]
        leaf = {"weight": "w", "bias": bias}.get(rest[-1], rest[-1])
        return "/".join([parts[0], *rest[:-1], leaf]), \
            leaf == "w" and tensor.dim() == 2
    leaf = {"weight": "table", "bias": bias}.get(parts[-1], parts[-1])
    return "/".join([*parts[:-1], leaf]), False


def is_stacked(key: str) -> bool:
    """Whether the reference's leaf ``key`` carries a leading layer axis."""
    return key.split("/")[0] in _STACKED


def reference_leaves(params: nn.Module
                     ) -> Dict[str, List[Tuple[str, bool]]]:
    """The reference's leaves as groups of the port's parameters: its key ->
    ``[(port name, transposed), ...]``, the layers of a stacked leaf in
    order (one entry for a leaf that is not stacked). A statistic that the
    reference takes over a whole leaf (Adafactor's factored moments, its
    update's RMS, int8 compression's scale) is taken over the group."""
    norms = {f"{mn}.bias" for mn, m in params.named_modules()
             if isinstance(m, Norm)}
    groups: Dict[str, List[Tuple[str, bool]]] = {}
    for name, p in params.named_parameters():
        key, transposed = jax_key(name, p, name in norms)
        groups.setdefault(key, []).append((name, transposed))
    return groups


def opt_state_from_jax(cfg, opt_state: Mapping[str, Any], params: nn.Module
                       ) -> Dict[str, Any]:
    """The reference's optimizer state (``init_opt`` / ``apply_updates``'s
    ``{"step", "inner"}``, as numpy arrays) as the port's, on the params'
    device: AdamW's ``m`` and ``v`` are trees like the params and map as
    they do; Adafactor's ``vr`` / ``vc`` / ``v`` stay in the reference's
    layout, keyed by its leaf (see ``optim/adafactor.py``)."""
    dev = next(params.parameters()).device
    inner = opt_state["inner"]
    if cfg.optimizer == "adafactor":
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, arr in flatten(inner).items():
            leaf, stat = key.rsplit("/", 1)
            out.setdefault(leaf, {})[stat] = _tensor(arr).to(dev)
    else:
        out = {mom: {n: t.to(dev) for n, t in
                     params_from_jax(inner[mom]).items()}
               for mom in ("m", "v")}
    return {"step": torch.tensor(int(np.asarray(opt_state["step"])),
                                 dtype=torch.int32, device=dev),
            "inner": out}


def train_state_from_jax(cfg, state: Mapping[str, Any], params: nn.Module
                         ) -> Dict[str, Any]:
    """The reference's train state (``{"params", "opt", "err"?}``, numpy)
    as the port's: ``params`` (the port's module) loaded with its params,
    the optimizer state by :func:`opt_state_from_jax`, compression's error
    feedback ``err`` mapped as the params are."""
    load_jax_params(params, state["params"])
    out = {"params": params,
           "opt": opt_state_from_jax(cfg, state["opt"], params)}
    if "err" in state:
        dev = next(params.parameters()).device
        out["err"] = {n: t.to(dev)
                      for n, t in params_from_jax(state["err"]).items()}
    return out
