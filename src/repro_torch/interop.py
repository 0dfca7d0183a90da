"""Carry parameters across from the reference package.

The reference keeps the dense decoder's params as a pytree of arrays whose
per-layer leaves are stacked on a leading [L] axis; its checkpointer
flattens the tree to ``/``-joined keys (``embed/table``,
``final_norm/scale``, ``layers/ln1/scale``, ``layers/attn/q/w``,
``layers/attn/q/b``, ``layers/mlp/up/w``, ...). :func:`params_from_jax`
takes that tree, nested or flat, as numpy arrays and returns a state dict
of the port's :class:`~repro_torch.models.transformer.DecoderLM`: the layer
axis is unstacked and ``[in, out]`` weights are transposed to
``nn.Linear``'s ``[out, in]``. Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


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


def _leaf_name(parts) -> str:
    *mods, leaf = parts
    name = {"w": "weight", "b": "bias", "table": "weight"}.get(leaf, leaf)
    return ".".join([*mods, name])


def params_from_jax(tree_or_flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the dense decoder from the reference's param tree."""
    flat = flatten(tree_or_flat)
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "layers":
            stacked = _tensor(arr)
            for i in range(stacked.shape[0]):
                t = stacked[i]
                if parts[-1] == "w":
                    t = t.T
                sd[f"layers.{i}." + _leaf_name(parts[1:])] = t.contiguous()
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
