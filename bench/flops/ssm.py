"""Analytic model FLOPs of a Mamba-2 (SSD) decoder's train step: a frozen
copy of the port's ``analysis/roofline.py::analytic_model_flops`` at train
shapes and of ``ModelConfig.param_count``, read from a configuration
file's ``model`` dict:

  6 N T  +  the SSD term 6 L B S (per-token chunked-dual FLOPs / 2).
"""
from __future__ import annotations


def param_count(m: dict) -> int:
    d, v = m["d_model"], m["vocab_size"]
    n = v * d if m.get("tie_embeddings", False) else 2 * v * d
    s = m["ssm"]
    d_in = s["expand"] * d
    nh = d_in // s["head_dim"]
    proj_in = d * (2 * d_in + 2 * s["state_dim"] + nh)
    per = proj_in + d_in * d + s["conv_width"] * (
        d_in + 2 * s["state_dim"]) + 3 * nh + 2 * d
    return n + m["num_layers"] * per


def _ssd_chunk_flops(m: dict) -> float:
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    nh = d_in // s["head_dim"]
    q, n, p = s["chunk"], s["state_dim"], s["head_dim"]
    return nh * (q * n / nh + q * p + 2 * n * p)


def train_step_flops(m: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one train step of ``rows`` x ``seq`` tokens."""
    return 6.0 * param_count(m) * rows * seq \
        + m["num_layers"] * 6.0 * rows * seq * _ssd_chunk_flops(m)
