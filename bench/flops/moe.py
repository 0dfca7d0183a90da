"""Analytic model FLOPs of a routed-MoE decoder's train step: a frozen copy
of the port's ``analysis/roofline.py::analytic_model_flops`` at train
shapes and of ``ModelConfig.param_count`` / ``active_param_count``, read
from a configuration file's ``model`` dict:

  6 N_active T  +  the causal attention term 12 L B S^2 H Dh / 2,

N_active counting, a layer, attention, the router, the ``top_k`` routed
experts and the two norms, and the table once (tied), as the port's count
does (it leaves out the final norm).
"""
from __future__ import annotations


def _shared(m: dict) -> tuple:
    """(table, one layer's attention, router and norms)."""
    d, v = m["d_model"], m["vocab_size"]
    n = v * d if m.get("tie_embeddings", False) else 2 * v * d
    hd = m.get("head_dim") or d // m["num_heads"]
    attn = d * m["num_heads"] * hd + 2 * d * m["num_kv_heads"] * hd \
        + m["num_heads"] * hd * d
    return n, attn + d * m["moe"]["num_experts"] + 2 * d


def _expert(m: dict) -> int:
    return (3 if m.get("glu", True) else 2) * m["d_model"] \
        * m["moe"]["expert_ff"]


def param_count(m: dict) -> int:
    """Every parameter, all experts."""
    n, per = _shared(m)
    return n + m["num_layers"] * (per + m["moe"]["num_experts"] * _expert(m))


def active_param_count(m: dict) -> int:
    """The parameters a token meets: its ``top_k`` experts a layer."""
    n, per = _shared(m)
    return n + m["num_layers"] * (per + m["moe"]["top_k"] * _expert(m))


def train_step_flops(m: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one train step of ``rows`` x ``seq`` tokens."""
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    return 6.0 * active_param_count(m) * rows * seq \
        + m["num_layers"] * 12.0 * rows * seq * seq \
        * m["num_heads"] * hd * 0.5
