"""The paper's use case, ML-shaped, on the PyTorch / CUDA port: a
hyperparameter sweep the user STEERS (the twin of
``examples/parameter_sweep_steering.py``).

Risers-analogue: instead of environmental-condition parameters, the sweep
members carry learning-rate scales. Mid-run the user runs a Q7-style
analysis ("which members' losses are diverging?") and a Q8-style adaptation
(prune the diverging members' remaining tasks — the paper's data reduction),
so compute is reallocated to promising members.

    PYTHONPATH=src python examples/torch_parameter_sweep_steering.py
    PYTHONPATH=src python examples/torch_parameter_sweep_steering.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.provenance import prov_document  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.flags import device_claims  # noqa: E402
from repro_torch.runtime.executor import TrainExecutor  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16,
                    help="steps per sweep member")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config("qwen2-0.5b")
    with device_claims(args.device != "cpu"):
        ex = TrainExecutor(
            cfg, num_workers=4, base_lr=1e-3,
            data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                batch_size=8), device=args.device)
    # 4 sweep members; member 3 has a divergently large lr
    sweep = {0: 1.0, 1: 2.0, 2: 4.0, 3: 64.0}
    for sid, scale in sweep.items():
        ex.submit_steps(args.steps, lr_scale=scale, sweep_id=sid)
    total = len(sweep) * args.steps
    print(f"sweep: 4 members x {args.steps} steps; member 3 lr_scale=64 "
          f"(diverges)")

    pruned = 0
    while ex.steering.q4_tasks_left() > 0:
        m = ex.tick()
        # --- user steering moment: after 12 ticks, inspect per-member loss
        if m and m.get("step") == 12 * 1:
            store = ex.wq.store
            fin = store.col("status") == 4
            losses = {}
            for sid in sweep:
                mask = fin & (store.col("in2") == sid)
                if mask.any():
                    losses[sid] = float(np.nanmean(store.col("out0")[mask]))
            print(f"\n[steering] Q7-style per-member mean loss: "
                  f"{ {k: round(v,3) for k,v in losses.items()} }")
            worst = max(losses, key=losses.get)
            pruned = ex.steering.prune("in0", sweep[worst] - 0.5,
                                       sweep[worst] + 0.5)
            print(f"[steering] Q8: pruned {pruned} remaining tasks of "
                  f"member {worst} (lr_scale={sweep[worst]})\n")
    c = ex.wq.counts()
    print(f"finished={c['FINISHED']} pruned={c['PRUNED']} "
          f"(compute saved: {c['PRUNED']}/{total} tasks)")
    # provenance export
    doc = prov_document(ex.wq)
    print(f"provenance: {len(doc['activity'])} activities, "
          f"{len(doc['used'])} usage edges, W3C PROV-shaped")
    ex.close()


if __name__ == "__main__":
    main()
