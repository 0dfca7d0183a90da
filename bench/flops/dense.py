"""Analytic model FLOPs of a dense decoder's train step: a frozen copy of
the port's ``analysis/roofline.py::analytic_model_flops`` at train shapes
and of ``ModelConfig.param_count``, read from a configuration file's
``model`` dict:

  6 N T  +  the causal attention term 12 L B S^2 H Dh / 2.
"""
from __future__ import annotations


def param_count(m: dict) -> int:
    d, v = m["d_model"], m["vocab_size"]
    n = v * d if m.get("tie_embeddings", False) else 2 * v * d
    hd = m.get("head_dim") or d // m["num_heads"]
    attn = d * m["num_heads"] * hd + 2 * d * m["num_kv_heads"] * hd \
        + m["num_heads"] * hd * d
    ff = (3 if m.get("glu", True) else 2) * d * m["d_ff"]
    return n + m["num_layers"] * (attn + ff + 2 * d)


def train_step_flops(m: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one train step of ``rows`` x ``seq`` tokens."""
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    return 6.0 * param_count(m) * rows * seq \
        + m["num_layers"] * 12.0 * rows * seq * seq \
        * m["num_heads"] * hd * 0.5
