"""A cell small enough for the CPU: the real harness and plain references
on tiny configurations of the two families, in a directory of its own."""
from __future__ import annotations

import copy
import json
from pathlib import Path

from benchlib import cells

TINY_MODELS = {
    "dense": {"num_layers": 2, "d_model": 32, "num_heads": 4,
              "num_kv_heads": 2, "head_dim": 8, "d_ff": 64,
              "vocab_size": 96, "loss_chunk": 16},
    "ssm": {"num_layers": 2, "d_model": 32, "num_heads": 4,
            "num_kv_heads": 4, "vocab_size": 96, "loss_chunk": 16,
            "ssm": {"state_dim": 8, "head_dim": 16, "expand": 2,
                    "chunk": 16, "conv_width": 4}},
}


def tiny_cell(tmp: Path, family: str = "dense", limits=None,
              rows: int = 4, seq: int = 32) -> dict:
    """Write a one-cell spec of the ``family``'s configuration cut to a
    tiny size under ``tmp``; returns the spec (BENCHMARK.json's form)."""
    conf_name = "qwen2-0.5b" if family == "dense" else "mamba2-1.3b"
    conf = cells.load_json(cells.BENCH / "configs" / f"{conf_name}.json")
    conf = copy.deepcopy(conf)
    conf["model"].update(TINY_MODELS[family])
    conf["model"]["name"] = f"tiny-{family}"
    mix = cells.load_json(cells.BENCH / "mixes" / "sweep-2k-b8.json")
    mix.update(members=4, steps_per_member=50, rows=rows, seq_len=seq)
    for d in ("configs", "mixes", "limits"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    (tmp / "configs" / "tiny.json").write_text(json.dumps(conf))
    (tmp / "mixes" / "tiny-mix.json").write_text(json.dumps(mix))
    lim = cells.load_json(
        cells.BENCH / "limits" / f"{conf_name}.sweep-2k.json")
    if limits:
        lim["limits"].update(limits)
    (tmp / "limits" / "tiny.json").write_text(json.dumps(lim))
    spec = cells.benchmark()
    spec = dict(spec, configs=[{"name": "tiny",
                                "file": str(tmp / "configs" / "tiny.json")}],
                workloads=[{"name": "tiny", "config": "tiny",
                            "traffic": "tiny-mix", "chips": 1}])
    for m in spec["per_layer"] + spec["end_to_end"]:
        m.pop("workloads", None)
    return spec
