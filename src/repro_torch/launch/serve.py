"""Serving entrypoint: WQ-driven continuous batching.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --smoke --requests 16 --device cpu

``--device`` defaults to ``cuda``: prefill and decode attention then run the
hand-written kernels, and the command fails when no card is present.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.runtime.executor import ServeExecutor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    ex = ServeExecutor(cfg, slots=args.slots,
                       max_len=64 if args.smoke else 4096, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.requests, 8)).astype(np.int32)
    t0 = time.time()
    ex.submit(prompts, max_new=args.max_new)
    n = ex.drain()
    if ex.device.type == "cuda":
        torch.cuda.synchronize(ex.device)
    dt = time.time() - t0
    print(f"served {ex.wq.counts()['FINISHED']} requests in {dt:.1f}s "
          f"({args.max_new * n / dt:.1f} tok/s) on {ex.device}")


if __name__ == "__main__":
    main()
