"""Training entrypoint: WQ-driven trainer (the reference's
``repro/launch/train.py``) on the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --steps 50

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 4 --seq-len 2048 --batch 8

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
      --steps 4 --seq-len 2048 --batch 8

``--device`` defaults to ``cuda``: attention (every family but SSM), the
SSD scan (SSM) and the RG-LRU scan (hybrid) then run forward and backward
in the hand-written kernels, and the command fails when no card is present.
Microbatches follow ``cfg.microbatches`` (4 for recurrentgemma-9b and
granite-moe-3b-a800m). The VLM and enc-dec archs train on the data
pipeline's patch embeddings and M-RoPE ids, or frames and tokens.
"""
from __future__ import annotations

import argparse

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.executor import TrainExecutor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU)")
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    seq = args.seq_len or (64 if args.smoke else 4096)
    batch = args.batch or (8 if args.smoke else 256)
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    ex = TrainExecutor(cfg, num_workers=args.workers, base_lr=args.lr,
                       checkpointer=ck, checkpoint_every=50,
                       data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=seq, batch_size=batch),
                       device=args.device)
    if args.resume and ck and ck.latest_step() is not None:
        ex.resume(*ck.restore(ex.state))
        print(f"resumed from step {ex.step}")
    ex.submit_steps(args.steps)
    hist = ex.run()
    ex.close()
    if hist:
        print(f"trained {len(hist)} steps on {ex.device}; "
              f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    if ck:
        ck.save(ex.step, ex.state, ex.wq)
        ck.wait()


if __name__ == "__main__":
    main()
