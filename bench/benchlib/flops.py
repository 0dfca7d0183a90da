"""Analytic model FLOPs of one train step: a frozen copy of the arithmetic
of the port's ``analysis/roofline.py::analytic_model_flops`` (train
shapes, dense and SSM families) and of ``ModelConfig.param_count``, read
from a configuration file's ``model`` dict:

  6 N T  +  the attention term 12 L B S^2 H Dh / 2 (causal)
         or the SSD term 6 L B S (per-token chunked-dual FLOPs / 2).
"""
from __future__ import annotations


def param_count(m: dict) -> int:
    d, v = m["d_model"], m["vocab_size"]
    n = v * d if m.get("tie_embeddings", False) else 2 * v * d
    if m["family"] == "ssm":
        s = m["ssm"]
        d_in = s["expand"] * d
        nh = d_in // s["head_dim"]
        proj_in = d * (2 * d_in + 2 * s["state_dim"] + nh)
        per = proj_in + d_in * d + s["conv_width"] * (
            d_in + 2 * s["state_dim"]) + 3 * nh + 2 * d
        return n + m["num_layers"] * per
    if m["family"] != "dense":
        raise NotImplementedError(f"family {m['family']!r}")
    hd = m.get("head_dim") or d // m["num_heads"]
    attn = d * m["num_heads"] * hd + 2 * d * m["num_kv_heads"] * hd \
        + m["num_heads"] * hd * d
    ff = (3 if m.get("glu", True) else 2) * d * m["d_ff"]
    return n + m["num_layers"] * (attn + ff + 2 * d)


def _ssd_chunk_flops(m: dict) -> float:
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    nh = d_in // s["head_dim"]
    q, n, p = s["chunk"], s["state_dim"], s["head_dim"]
    return nh * (q * n / nh + q * p + 2 * n * p)


def train_step_flops(m: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one train step of ``rows`` x ``seq`` tokens."""
    base = 6.0 * param_count(m) * rows * seq
    if m["family"] == "ssm":
        return base + m["num_layers"] * 6.0 * rows * seq \
            * _ssd_chunk_flops(m)
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    return base + m["num_layers"] * 12.0 * rows * seq * seq \
        * m["num_heads"] * hd * 0.5
