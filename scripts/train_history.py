#!/usr/bin/env python3
"""A few train steps of a layer cut of one model, at full width and in its
train dtype, on the card (the kernels) and on the CPU (the plain versions)
from the same master params and the same batches, side by side: each
step's loss and grad norm on both, and their gap.

    python scripts/train_history.py [--arch mamba2-1.3b] [--layers 2]
        [--batch 2] [--seq-len 512] [--steps 6] [--lrs 3e-4,3e-3]
        [--seed 0]

A second reading of a card train run's loss history: each step is the
executor's (``make_train_step`` at a fixed lr, the batch of shard ``step``
as ``TrainExecutor`` draws it). Where the card's losses rise and fall as
the CPU's do, the shape of the history comes from the optimizer and its
settings, not from the kernels. The default S 512 gives mamba2's SSD scan
two chunks of 256, so the terms carried across chunks run in both
directions. Prints one JSON line per lr and step, and a last line with
the card's name and the largest gaps. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for  # noqa: E402
from repro_torch.launch.steps import (copy_params, init_train_state,  # noqa: E402
                                      make_train_step)
from repro_torch.optim import init_opt  # noqa: E402


def history(cfg, dcfg, steps, lr, seed, dev):
    """(card records, CPU records) of ``steps`` train steps from the same
    master params, drawn on the card from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    card = init_train_state(cfg, gen)
    host_params = copy_params(card["params"],
                              lambda t: t.to("cpu", copy=True))
    host = {"params": host_params.requires_grad_(True),
            "opt": init_opt(cfg, host_params)}
    step_fn = make_train_step(cfg)
    out = ([], [])
    for step in range(steps):
        tok = batch_for(cfg, dcfg, step)
        for i, (state, d) in enumerate(((card, dev), (host, "cpu"))):
            batch = {k: torch.as_tensor(v, device=d) for k, v in tok.items()}
            new, m = step_fn(state, batch, {"lr": lr})
            state.update(new)
            out[i].append((float(m["loss"]), float(m["grad_norm"])))
    del card, host
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--lrs", default="3e-4,3e-3")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_history.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, num_layers=args.layers)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      batch_size=args.batch)
    gaps = {}
    for lr in (float(x) for x in args.lrs.split(",")):
        on_card, on_cpu = history(cfg, dcfg, args.steps, lr, args.seed, dev)
        rel = []
        for step, ((lc, gc), (lh, gh)) in enumerate(zip(on_card, on_cpu)):
            rel.append([abs(lc - lh) / abs(lh), abs(gc - gh) / gh])
            print(json.dumps({"arch": cfg.name, "layers": args.layers,
                              "dtype": cfg.dtype, "batch": args.batch,
                              "seq_len": args.seq_len, "lr": lr,
                              "step": step, "loss": [lc, lh],
                              "grad_norm": [gc, gh],
                              "loss_rel_gap": rel[-1][0],
                              "grad_norm_rel_gap": rel[-1][1]}), flush=True)
        gaps[str(lr)] = np.max(rel, axis=0).tolist()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "largest_rel_gap_by_lr":
                      {k: {"loss": v[0], "grad_norm": v[1]}
                       for k, v in gaps.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
