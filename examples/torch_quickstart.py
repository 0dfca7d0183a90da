"""Quickstart on the PyTorch / CUDA port: WQ-driven training of a small LM
with live steering queries (the twin of ``examples/quickstart.py``).

The SchalaDB work queue schedules training tasks across (simulated) workers,
captures provenance (loss / grad-norm / timing) into the same store, and the
steering engine answers the paper's Q1/Q4/Q5-style queries WHILE training.
On the card the store claims through the ``wq_claim`` kernel and the model
attends through the flash kernels.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 60]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.flags import device_claims  # noqa: E402
from repro_torch.runtime.executor import TrainExecutor  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    # the store claims on the card where there is one (the wq_claim kernel)
    with device_claims(args.device != "cpu"):
        ex = TrainExecutor(
            cfg, num_workers=args.workers, base_lr=3e-3,
            data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                batch_size=8), device=args.device)
    ex.submit_steps(args.steps)
    print(f"workflow: {args.steps} train tasks over {args.workers} workers "
          f"(partitioned work queue) on {ex.device}")

    t0 = time.time()
    while ex.steering.q4_tasks_left() > 0:
        m = ex.tick()
        if m and m["step"] % 10 == 0:
            q1 = ex.steering.q1_recent_status_by_node(time.time())
            print(f"step {m['step']:4d} loss {m['loss']:.4f} "
                  f"grad {m['grad_norm']:.3f} | Q4 left: "
                  f"{ex.steering.q4_tasks_left():3d} | Q1 finished/node: "
                  f"{ {k: v['finished'] for k, v in q1.items()} }")
    hist = ex.history
    print(f"\ndone in {time.time()-t0:.1f}s; "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    mon = ex.steering.device_monitor()
    print(f"on-device monitor (HTAP mirror): {mon}")
    ex.close()


if __name__ == "__main__":
    main()
